"""Sector sweep / spectrum determination.

Parity target: reference ED_DIAG.f90 + ED_DIAG_NORMAL.f90 (:76-296 sweep,
solver choice :119-252, post-diag trimming and adaptive neigen feedback
:382-519); counterpart of edipack_tpu.solver.diag.diagonalize_sites and
diagonalize:

* sectors with dim <= lanc_dim_threshold are padded into power-of-two
  buckets and diagonalized with one batched ``torch.linalg.eigh`` per
  bucket; with several impurity sites (real-space DMFT,
  :func:`diagonalize_sites`) every site's sectors join the same buckets;
* larger sectors run restarted deflated Lanczos, one sector at a time, in
  the operator's dtype (``mv.dtype``: f32 for ``ed_precision="float32"``,
  complex128 for the joint modes);
* twin sectors: normal mode and superc rebuild the elided twin's states by
  a (signed) relabeling of the basis; nonsu2 re-solves an elided sector
  whose levels the trim would keep.

Retained eigenvectors stay on the solve's device, in the dtype that gave
them (dense buckets f64, or complex128 when a sector's H is complex, as in
edipack_tpu).

Over a mesh of ranks (parallel.mesh, ``mesh=``): each rank diagonalizes
its share of every bucket chunk and an all-gather returns every eigenpair
to every rank (edipack_tpu.solver.diag's sharded buckets); a sector whose
operator is split over the mesh runs its Lanczos on its rows, and each
kept state is gathered whole on every rank, so that everything after the
sweep runs as without a mesh.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EDConfig
from ..device import working_dtype
from ..fock import popcount
from ..ops.lanczos import apply_full, batched_eigh, eigsh_lowest
from ..sectors import Sector, SectorTable
from .eigenspace import EigenState, StateList

# ed_sanitize: <u,Hv> vs <Hu,v> relative defect allowed for an operator of
# each dtype (f32: edipack_tpu's limit, set by the f32 matvec noise)
HERMITICITY_LIMIT = {torch.float64: 1e-10, torch.float32: 5e-5,
                     torch.complex128: 1e-10, torch.complex64: 5e-5}
# T=0 ground multiplet: levels within this many units of the working
# dtype's rounding of E0 count as degenerate, whatever gs_threshold says
GS_ULPS = 8


def gs_window(cfg: EDConfig, e0: float) -> float:
    """The T=0 ground-multiplet window: gs_threshold, widened to GS_ULPS
    roundings of E0 in the working dtype. An f32 solve's Lanczos energies
    are f32 Ritz values, so exactly degenerate levels of two sectors (spin
    twins) come out one or two f32 steps of E0 apart; in f64 the widening
    is below 1e-13 and gs_threshold (1e-9) rules."""
    eps = torch.finfo(working_dtype(cfg)).eps
    return max(cfg.gs_threshold, GS_ULPS * eps * abs(e0))


@dataclass
class DiagResult:
    state_list: StateList
    evals_by_sector: Dict[int, np.ndarray]
    neigen_sector: np.ndarray
    zeta: float
    e0: float
    # finite-T annealing feedback (reference ed_post_diag
    # ED_DIAG_NORMAL.f90:489-517): the adapted total-state budget the next
    # solve should request, and the per-sector retained-state histogram
    lanc_nstates_total: int = 0
    sector_histogram: Optional[np.ndarray] = None
    # Lanczos sector -> (restarts, restart cap, sweep matvecs)
    lanczos_stats: Dict[int, Tuple[int, int, int]] = field(
        default_factory=dict)


def _pad_pow2_bucket(dim: int) -> int:
    """Bucket size: next power of two (bounded number of batch shapes)."""
    b = 8
    while b < dim:
        b *= 2
    return b


def sanitize_enabled(cfg: EDConfig) -> bool:
    return bool(cfg.ed_sanitize
                or os.environ.get("EDIPACK_TPU_SANITIZE", "") not in ("", "0"))


def _sanitize_mv(i: int, mv) -> None:
    """Debug-build self-check of one sector operator: <u, Hv> == <Hu, v> on
    a random pair, which catches term sign/layout bugs at the operator
    level."""
    rng = np.random.default_rng(1234 + i)
    proj = getattr(mv, "v0_project", None)

    def rand_vec():
        x = rng.normal(size=mv.dim)
        if mv.dtype.is_complex:
            x = x + 1j * rng.normal(size=mv.dim)
        v = torch.as_tensor(x, dtype=mv.dtype, device=mv.device)
        if proj is None:
            return v
        if getattr(mv, "mesh", None) is None:
            return proj(v)
        return mv.gather(proj(mv.local(v)))

    u, v = rand_vec(), rand_vec()
    hu, hv = apply_full(mv, u), apply_full(mv, v)
    scale = float(torch.linalg.norm(u) * torch.linalg.norm(hv)
                  + torch.linalg.norm(hu) * torch.linalg.norm(v)) + 1e-30
    defect = abs(complex(torch.vdot(u, hv) - torch.vdot(hu, v))) / scale
    limit = HERMITICITY_LIMIT[mv.dtype]
    if not np.isfinite(defect) or defect > limit:
        raise AssertionError(
            f"[ed_sanitize] sector {i}: matvec Hermiticity defect "
            f"{defect:.3e} (limit {limit}) — operator term bug or NaN")


def _sanitize_spectrum(i: int, vals: np.ndarray) -> None:
    if not np.all(np.isfinite(np.asarray(vals))):
        raise AssertionError(
            f"[ed_sanitize] sector {i}: non-finite eigenvalues {vals}")


def _dense_buckets(cfg: EDConfig, table: SectorTable,
                   items: List[Tuple[int, int]], dense_builders: Sequence,
                   neigen: np.ndarray, sls: List[StateList],
                   evals_by_sector: List[Dict[int, np.ndarray]],
                   device: torch.device, mesh=None) -> None:
    """Diagonalize the (site, sector) pairs of ``items``: every site's
    sectors join the same power-of-two buckets, one batched eigh each
    (with ``mesh``, :func:`_shared_eigh`)."""
    buckets: Dict[int, List[Tuple[int, int]]] = {}
    for s, i in items:
        buckets.setdefault(_pad_pow2_bucket(table.get_dim(i)),
                           []).append((s, i))
    for bsize, bitems in sorted(buckets.items()):
        if cfg.ed_verbose >= 4:
            print(f"[edipack_tpu_torch:DEBUG] dense bucket pad={bsize}: "
                  f"{len(bitems)} (site, sector) items {bitems[:12]}"
                  f"{'...' if len(bitems) > 12 else ''}")
        # chunk large batches to bound memory
        max_batch = max(1, (1 << 22) // (bsize * bsize))
        for lo in range(0, len(bitems), max_batch):
            chunk = bitems[lo:lo + max_batch]
            hs = [dense_builders[s](table.sector(i)) for s, i in chunk]
            cplx = any(np.iscomplexobj(h) for h in hs)
            mats = np.zeros((len(chunk), bsize, bsize),
                            complex if cplx else float)
            dims = []
            for bi, ((s, i), h) in enumerate(zip(chunk, hs)):
                d = h.shape[0]
                if sanitize_enabled(cfg) and not np.allclose(
                        h, h.conj().T, atol=1e-10 * (np.abs(h).max() + 1)):
                    raise AssertionError(
                        f"[ed_sanitize] sector {i} (site {s}): dense H is "
                        f"not Hermitian — term builder bug")
                dims.append(d)
                mats[bi, :d, :d] = h
                # push padding levels far above this matrix's spectrum
                pad = np.abs(h).sum() + 1.0
                mats[bi, d:, d:] = np.eye(bsize - d) * pad if bsize > d else 0.0
            hmats = torch.as_tensor(mats, device=device)
            evals, evecs = batched_eigh(hmats) if mesh is None \
                or len(chunk) < 2 else _shared_eigh(hmats, mesh)
            evals = evals.cpu().numpy()
            for bi, (s, i) in enumerate(chunk):
                d = dims[bi]
                ev = evals[bi, :d]
                evals_by_sector[s][i] = ev
                # keep at least the sector's full near-degenerate ground
                # multiplet so the T=0 trim can't miss degeneracies
                n_deg = int(np.sum(ev - ev[0] <= cfg.gs_threshold))
                keep = min(d, max(neigen[s, i], n_deg, 1))
                for j in range(keep):
                    sls[s].add(EigenState(float(ev[j]), i, evecs[bi, :d, j]))


def _shared_eigh(mats: torch.Tensor, mesh) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """:func:`batched_eigh` of a chunk shared by the ranks: the chunk is
    padded with identity matrices to a multiple of the world size (as
    edipack_tpu/solver/diag.py:156-160 pads), each rank diagonalizes its
    contiguous share, and an all-gather returns every eigenpair."""
    nb, bsize = mats.shape[0], mats.shape[1]
    mesh.agree("a dense bucket chunk (count, size)", (nb, bsize))
    per = -(-nb // mesh.world)
    pad = per * mesh.world - nb
    if pad:
        eye = torch.eye(bsize, dtype=mats.dtype, device=mats.device)
        mats = torch.cat([mats, eye.expand(pad, bsize, bsize)])
    lo = mesh.rank * per
    evals, evecs = batched_eigh(mats[lo:lo + per])
    evals = mesh.all_gather(evals).reshape(-1, bsize)[:nb]
    evecs = mesh.all_gather(evecs).reshape(-1, bsize, bsize)[:nb]
    return evals, evecs


def _lanczos_solve_sector(cfg: EDConfig, table: SectorTable, i: int,
                          matvec_builder, nev_req: int, sl: StateList,
                          evals_by_sector: Dict[int, np.ndarray]
                          ) -> Tuple[int, int, int]:
    """Solve one Lanczos-sized sector into ``sl`` / ``evals_by_sector``;
    returns (restarts, restart cap, sweep matvecs)."""
    mv = matvec_builder(table.sector(i))
    if sanitize_enabled(cfg):
        _sanitize_mv(i, mv)
    nev = min(max(nev_req, 1), mv.dim - 1) or 1
    m = min(mv.dim, max(cfg.lanc_ncv_factor * nev + cfg.lanc_ncv_add,
                        4 * nev + 24, 48))
    if cfg.lanc_method == "lanczos":
        # plain-Lanczos semantics (reference sp_lanc_eigh, T=0): one long
        # sweep sized by lanc_niter instead of restarted NCV blocks
        m = min(mv.dim, max(m, min(cfg.lanc_niter, 512)))
    cap = max(4, cfg.lanc_niter // m)
    stats: dict = {}
    mesh = getattr(mv, "mesh", None)
    vals, vecs = eigsh_lowest(mv, mv.dim, nev, dtype=mv.dtype, m=m,
                              tol=max(cfg.lanc_tolerance, 1e-14),
                              max_restarts=cap, stats=stats, mesh=mesh)
    if mesh is not None:
        vecs = mv.gather(vecs)      # every kept state whole on every rank
    if sanitize_enabled(cfg):
        _sanitize_spectrum(i, vals)
    evals_by_sector[i] = vals
    conv = getattr(mv, "from_internal_flat", None)
    for j in range(len(vals)):
        vec = conv(vecs[j]) if conv is not None else vecs[j]
        sl.add(EigenState(float(vals[j]), i, vec))
    return stats["n_restarts"], cap, stats["n_matvecs"]


def _resolve_nonsu2_twins(cfg: EDConfig, table: SectorTable, sl: StateList,
                          evals_by_sector: Dict[int, np.ndarray],
                          matvec_builder, dense_builder, neigen: np.ndarray,
                          twin_mask: np.ndarray,
                          sector_mask: Optional[np.ndarray],
                          device: torch.device,
                          lanczos_stats: Dict[int, Tuple[int, int, int]]
                          ) -> None:
    """Solve any twin-elided nonsu2 sector whose spectrum (mirrored from
    its solved partner) would enter the trimmed state list (reference
    ED_SETUP.f90:592-603 halves the nonsu2 scan; no basis relabeling holds
    for an arbitrary bath, so a kept twin's vectors come from an exact
    re-solve; at T=0 the ground sector is its own twin)."""
    if len(sl) == 0:
        return
    cand = []
    for i in range(len(table)):
        if twin_mask[i] or table.get_dim(i) == 0:
            continue
        if sector_mask is not None and not sector_mask[i]:
            continue   # masked by the user, not elided as a twin
        j = table.twin_of(i)
        if j == i or j not in evals_by_sector:
            continue
        cand.append((i, evals_by_sector[j]))
    if not cand:
        return
    e0 = min(min(st.energy for st in sl),
             min(float(ev[0]) for _, ev in cand if len(ev)))
    for i, ev in cand:
        if len(ev) == 0:
            continue
        if cfg.ed_finite_temp:
            need = np.exp(-cfg.beta * (float(ev[0]) - e0)) > cfg.cutoff
        else:
            need = float(ev[0]) - e0 <= cfg.gs_threshold
        if not need:
            # energy bookkeeping only (evals getters, neigen annealing)
            evals_by_sector[i] = np.asarray(ev).copy()
            continue
        if table.get_dim(i) <= cfg.lanc_dim_threshold:
            evs, evecs = np.linalg.eigh(dense_builder(table.sector(i)))
            evals_by_sector[i] = evs
            n_deg = int(np.sum(evs - evs[0] <= cfg.gs_threshold))
            keep = min(len(evs), max(int(neigen[i]), n_deg, 1))
            for k in range(keep):
                sl.add(EigenState(float(evs[k]), i, torch.as_tensor(
                    evecs[:, k], device=device)))
        else:
            lanczos_stats[i] = _lanczos_solve_sector(
                cfg, table, i, matvec_builder, int(neigen[i]), sl,
                evals_by_sector)


def _twin_state_joint(sec: Sector, sec_twin: Sector,
                      vector: torch.Tensor) -> torch.Tensor:
    """superc twin eigenvector: Sz -> -Sz is the spin-swap relabeling of the
    joint basis, |up,dw> -> (-1)^{nup(nup-1)/2 + ndw(ndw-1)/2} |dw,up>
    (reference twin_sector_order + flip_state_other,
    ED_SECTOR.f90:1776-1816; the sign is the JW reordering of each spin
    block's internal string)."""
    ns = sec.ns
    st = np.asarray(sec.states)
    mask = (np.int64(1) << np.int64(ns)) - 1
    nup = popcount(st & mask)
    ndw = popcount(st >> np.int64(ns))
    sign = (-1.0) ** ((nup * (nup - 1)) // 2 + (ndw * (ndw - 1)) // 2)
    flip = (st >> np.int64(ns)) | ((st & mask) << np.int64(ns))
    pos = torch.as_tensor(np.searchsorted(np.asarray(sec_twin.states), flip),
                          device=vector.device)
    v = vector.reshape(sec.dim_ph, sec.dim_el)
    w = torch.zeros_like(v)
    w[:, pos] = v * torch.as_tensor(sign, dtype=v.dtype,
                                    device=v.device)[None, :]
    return w.reshape(-1)


def _finish(cfg: EDConfig, table: SectorTable, sl: StateList,
            evals_by_sector: Dict[int, np.ndarray], neigen: np.ndarray,
            twin_mask: np.ndarray, nsec: int,
            lanczos_stats: Dict[int, Tuple[int, int, int]]) -> DiagResult:
    if len(sl) == 0:
        raise RuntimeError("no eigenstates found (all sectors empty?)")

    # twin reconstruction (reference twin_sector_order,
    # ED_SECTOR.f90:1747-1843): normal mode, the twin (Ndw,Nup) state is the
    # transpose of V[ph, dw, up]; superc, the signed spin-swap permutation
    # of the joint basis (_twin_state_joint); nonsu2 solved its twins
    # (_resolve_nonsu2_twins)
    if cfg.ed_twin and cfg.ed_mode in ("normal", "superc"):
        for st in list(sl.states):
            j = table.twin_of(st.sector)
            if j != st.sector and not twin_mask[j]:
                sec = table.sector(st.sector)
                if cfg.ed_mode == "normal":
                    v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw,
                                           sec.dim_up)
                    vt = v3.transpose(1, 2).reshape(-1)
                else:
                    vt = _twin_state_joint(sec, table.sector(j), st.vector)
                sl.add(EigenState(st.energy, j, vt, twin_of=st.sector))
                if st.sector in evals_by_sector:
                    evals_by_sector[j] = evals_by_sector[st.sector]

    # trim + adaptive feedback (reference ed_post_diag,
    # ED_DIAG_NORMAL.f90:443-517); the T=0 window is gs_window, finite T
    # keeps the lowest lanc_nstates_total states above the cutoff
    trimmed = sl.trim(cfg.ed_finite_temp, cfg.cutoff, gs_window(cfg, sl.e0),
                      cfg.lanc_nstates_total)
    counts = np.zeros(nsec, dtype=int)
    for st in trimmed:
        counts[st.sector] += 1
    new_neigen = neigen.copy()
    new_total = cfg.lanc_nstates_total
    if cfg.ed_finite_temp:
        # per-sector annealing: sectors present in the retained list get one
        # more requested state, absent ones one fewer; clamp to
        # [1, count + 1] (:475-487)
        for i in range(nsec):
            new_neigen[i] = neigen[i] + 1 if counts[i] > 0 else neigen[i] - 1
            new_neigen[i] = min(new_neigen[i], counts[i] + 1)
            new_neigen[i] = max(new_neigen[i], 1)
        # total-budget annealing (:489-517): if the Boltzmann weight of the
        # highest retained state is still above cutoff, the spectrum window
        # was too small -> grow the budget; otherwise settle it just above
        # the trimmed size
        sl.sort()
        e0_all, emax = sl.e0, sl.states[-1].energy
        if np.exp(-cfg.beta * (emax - e0_all)) > cfg.cutoff:
            new_total = cfg.lanc_nstates_total + cfg.lanc_nstates_step
        else:
            new_total = max(len(trimmed), cfg.lanc_nstates_step) \
                + cfg.lanc_nstates_step
    else:
        for i in range(nsec):
            if counts[i] >= neigen[i] and counts[i] > 0:
                new_neigen[i] = min(neigen[i] + cfg.lanc_nstates_step,
                                    max(table.get_dim(i), 1))
            elif counts[i] > 0:
                new_neigen[i] = max(counts[i] + 1, 1)
    return DiagResult(trimmed, evals_by_sector, new_neigen,
                      trimmed.partition_function(), trimmed.e0,
                      lanc_nstates_total=new_total,
                      sector_histogram=counts, lanczos_stats=lanczos_stats)


def diagonalize_sites(cfg: EDConfig, table: SectorTable,
                      matvec_builders: Sequence[Callable[[Sector], object]],
                      dense_builders: Sequence[Callable[[Sector], np.ndarray]],
                      device: torch.device,
                      neigen_overrides: Optional[Sequence] = None,
                      sector_masks: Optional[Sequence] = None,
                      mesh=None) -> List[DiagResult]:
    """Sweep every (site, sector) pair; one DiagResult per site.

    The sites share the sector structure (``table``) and the solver knobs
    of ``cfg``; each site's physics (Hloc, bath, U) lives in its builders.
    The dense sectors of every site share the power-of-two buckets, so a
    bucket is one batched eigh over sites and sectors together (the
    reference round-robins sites over MPI ranks, E2I_MAIN.f90:253-296).
    The Lanczos sectors run one (site, sector) at a time through the
    site's own operator; their start vectors depend on the sector only
    (ops.lanczos.START_SEED), so site s of a sweep equals a lone solve of
    site s. The nonsu2 twin re-solve, the twin reconstruction and the trim
    run per site.

    ``matvec_builders[s](sec)``: device matvec callable with .dim/.device
    ``dense_builders[s](sec)``: dense sector H (dim <= lanc_dim_threshold)
    ``mesh``: the ranks that share the dense buckets (their builders
    split the sectors they choose)
    """
    nsites = len(dense_builders)
    nsec = len(table)
    neigen = np.full((nsites, nsec), cfg.lanc_nstates_sector, dtype=int)
    if neigen_overrides is not None:
        for s, ov in enumerate(neigen_overrides):
            if ov is not None:
                neigen[s, :] = np.asarray(ov, int)
    twin_masks = []
    for s in range(nsites):
        m = table.twin_mask()
        if sector_masks is not None and sector_masks[s] is not None:
            m = m & np.asarray(sector_masks[s], bool)
        twin_masks.append(m)
    sls = [StateList(beta=cfg.beta) for _ in range(nsites)]
    evals_by_sector: List[Dict[int, np.ndarray]] = [{} for _ in range(nsites)]

    dense_items, lanc_items = [], []
    for s in range(nsites):
        for i in range(nsec):
            dim = table.get_dim(i)
            if not twin_masks[s][i] or dim == 0:
                continue
            (dense_items if dim <= cfg.lanc_dim_threshold
             else lanc_items).append((s, i))

    _dense_buckets(cfg, table, dense_items, dense_builders, neigen, sls,
                   evals_by_sector, device, mesh)

    sector_times: List[Tuple] = []
    lanczos_stats: List[Dict[int, Tuple[int, int, int]]] = [
        {} for _ in range(nsites)]
    for s, i in lanc_items:
        t0 = time.perf_counter()
        lanczos_stats[s][i] = _lanczos_solve_sector(
            cfg, table, i, matvec_builders[s], neigen[s, i], sls[s],
            evals_by_sector[s])
        sector_times.append((s, i, table.get_dim(i),
                             len(evals_by_sector[s][i]),
                             time.perf_counter() - t0))
    if cfg.ed_verbose >= 3 and sector_times:
        print("[edipack_tpu_torch] per-sector Lanczos timings:")
        for s, i, d, nv, dt in sorted(sector_times,
                                      key=lambda t: -t[4])[:20]:
            site = f"site {s} " if nsites > 1 else ""
            print(f"  {site}sector {i:4d} dim {d:>10d} nev {nv}  "
                  f"{dt:8.3f}s")
    if cfg.ed_twin and cfg.ed_mode == "nonsu2":
        for s in range(nsites):
            _resolve_nonsu2_twins(
                cfg, table, sls[s], evals_by_sector[s], matvec_builders[s],
                dense_builders[s], neigen[s], twin_masks[s],
                sector_masks[s] if sector_masks is not None else None,
                device, lanczos_stats[s])
    return [_finish(cfg, table, sls[s], evals_by_sector[s], neigen[s],
                    twin_masks[s], nsec, lanczos_stats[s])
            for s in range(nsites)]


def diagonalize(cfg: EDConfig, table: SectorTable,
                matvec_builder: Callable[[Sector], object],
                dense_builder: Callable[[Sector], np.ndarray],
                device: torch.device,
                neigen_override: Optional[np.ndarray] = None,
                sector_mask: Optional[np.ndarray] = None,
                mesh=None) -> DiagResult:
    """Sweep every sector of ``table`` (T = 0 or, with ed_finite_temp, the
    thermal window), or those of ``sector_mask`` (the ed_sectors restart,
    io.read_sectors_restart): the one-site specialization of
    :func:`diagonalize_sites`.

    ``matvec_builder(sec)``: device matvec callable with .dim/.device
    ``dense_builder(sec)``: dense sector H (dim <= lanc_dim_threshold)
    """
    return diagonalize_sites(cfg, table, [matvec_builder], [dense_builder],
                             device, neigen_overrides=[neigen_override],
                             sector_masks=[sector_mask], mesh=mesh)[0]
