"""Sector sweep / spectrum determination.

Parity target: reference ED_DIAG.f90 + ED_DIAG_NORMAL.f90 (:76-296 sweep,
solver choice :119-252, post-diag trimming and adaptive neigen feedback
:382-519); counterpart of edipack_tpu.solver.diag.diagonalize:

* sectors with dim <= lanc_dim_threshold are padded into power-of-two
  buckets and diagonalized with one batched ``torch.linalg.eigh`` per
  bucket;
* larger sectors run restarted deflated Lanczos, one sector at a time, in
  the operator's dtype (``mv.dtype``: f32 for ``ed_precision="float32"``).

Retained eigenvectors stay on the solve's device, in the dtype that gave
them (dense buckets f64, as in edipack_tpu).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EDConfig
from ..device import working_dtype
from ..ops.lanczos import batched_eigh, eigsh_lowest
from ..sectors import Sector, SectorTable
from .eigenspace import EigenState, StateList

# ed_sanitize: <u,Hv> vs <Hu,v> relative defect allowed for an operator of
# each dtype (f32: edipack_tpu's limit, set by the f32 matvec noise)
HERMITICITY_LIMIT = {torch.float64: 1e-10, torch.float32: 5e-5}
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
        v = torch.as_tensor(rng.normal(size=mv.dim), dtype=mv.dtype,
                            device=mv.device)
        return proj(v) if proj is not None else v

    u, v = rand_vec(), rand_vec()
    hu, hv = mv(u), mv(v)
    scale = float(torch.linalg.norm(u) * torch.linalg.norm(hv)
                  + torch.linalg.norm(hu) * torch.linalg.norm(v)) + 1e-30
    defect = abs(float(torch.dot(u, hv) - torch.dot(hu, v))) / scale
    limit = HERMITICITY_LIMIT[mv.dtype]
    if not np.isfinite(defect) or defect > limit:
        raise AssertionError(
            f"[ed_sanitize] sector {i}: matvec Hermiticity defect "
            f"{defect:.3e} (limit {limit}) — operator term bug or NaN")


def _sanitize_spectrum(i: int, vals: np.ndarray) -> None:
    if not np.all(np.isfinite(np.asarray(vals))):
        raise AssertionError(
            f"[ed_sanitize] sector {i}: non-finite eigenvalues {vals}")


def _dense_buckets(cfg: EDConfig, table: SectorTable, items: List[int],
                   dense_builder, neigen: np.ndarray, sl: StateList,
                   evals_by_sector: Dict[int, np.ndarray],
                   device: torch.device) -> None:
    buckets: Dict[int, List[int]] = {}
    for i in items:
        buckets.setdefault(_pad_pow2_bucket(table.get_dim(i)), []).append(i)
    for bsize, bitems in sorted(buckets.items()):
        # chunk large batches to bound memory
        max_batch = max(1, (1 << 22) // (bsize * bsize))
        for lo in range(0, len(bitems), max_batch):
            chunk = bitems[lo:lo + max_batch]
            mats = np.zeros((len(chunk), bsize, bsize))
            dims = []
            for bi, i in enumerate(chunk):
                h = dense_builder(table.sector(i))
                d = h.shape[0]
                if sanitize_enabled(cfg) and not np.allclose(
                        h, h.T, atol=1e-10 * (np.abs(h).max() + 1)):
                    raise AssertionError(
                        f"[ed_sanitize] sector {i}: dense H is not "
                        f"Hermitian — term builder bug")
                dims.append(d)
                mats[bi, :d, :d] = h
                # push padding levels far above the physical spectrum
                pad = np.abs(h).sum() + 1.0
                mats[bi, d:, d:] = np.eye(bsize - d) * pad if bsize > d else 0.0
            evals, evecs = batched_eigh(torch.as_tensor(mats, device=device))
            evals = evals.cpu().numpy()
            for bi, i in enumerate(chunk):
                d = dims[bi]
                ev = evals[bi, :d]
                evals_by_sector[i] = ev
                # keep at least the sector's full near-degenerate ground
                # multiplet so the T=0 trim can't miss degeneracies
                n_deg = int(np.sum(ev - ev[0] <= cfg.gs_threshold))
                keep = min(d, max(neigen[i], n_deg, 1))
                for j in range(keep):
                    sl.add(EigenState(float(ev[j]), i, evecs[bi, :d, j]))


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
    vals, vecs = eigsh_lowest(mv, mv.dim, nev, dtype=mv.dtype, m=m,
                              tol=max(cfg.lanc_tolerance, 1e-14),
                              max_restarts=cap, stats=stats)
    if sanitize_enabled(cfg):
        _sanitize_spectrum(i, vals)
    evals_by_sector[i] = vals
    conv = getattr(mv, "from_internal_flat", None)
    for j in range(len(vals)):
        vec = conv(vecs[j]) if conv is not None else vecs[j]
        sl.add(EigenState(float(vals[j]), i, vec))
    return stats["n_restarts"], cap, stats["n_matvecs"]


def _finish(cfg: EDConfig, table: SectorTable, sl: StateList,
            evals_by_sector: Dict[int, np.ndarray], neigen: np.ndarray,
            twin_mask: np.ndarray, nsec: int,
            lanczos_stats: Dict[int, Tuple[int, int, int]]) -> DiagResult:
    if len(sl) == 0:
        raise RuntimeError("no eigenstates found (all sectors empty?)")

    # twin reconstruction (reference twin_sector_order,
    # ED_SECTOR.f90:1747-1843): the twin (Ndw,Nup) state is the transpose of
    # V[ph, dw, up]
    if cfg.ed_twin:
        for st in list(sl.states):
            j = table.twin_of(st.sector)
            if j != st.sector and not twin_mask[j]:
                sec = table.sector(st.sector)
                v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
                vt = v3.transpose(1, 2).reshape(-1)
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


def diagonalize(cfg: EDConfig, table: SectorTable,
                matvec_builder: Callable[[Sector], object],
                dense_builder: Callable[[Sector], np.ndarray],
                device: torch.device,
                neigen_override: Optional[np.ndarray] = None,
                sector_mask: Optional[np.ndarray] = None) -> DiagResult:
    """Sweep every sector of ``table`` (T = 0 or, with ed_finite_temp, the
    thermal window), or those of ``sector_mask`` (the ed_sectors restart,
    io.read_sectors_restart).

    ``matvec_builder(sec)``: device matvec callable with .dim/.device
    ``dense_builder(sec)``: dense sector H (dim <= lanc_dim_threshold)
    """
    nsec = len(table)
    neigen = np.full(nsec, cfg.lanc_nstates_sector, dtype=int)
    if neigen_override is not None:
        neigen[:] = np.asarray(neigen_override, int)
    twin_mask = table.twin_mask()
    if sector_mask is not None:
        twin_mask = twin_mask & np.asarray(sector_mask, bool)
    sl = StateList(beta=cfg.beta)
    evals_by_sector: Dict[int, np.ndarray] = {}

    dense_items, lanc_items = [], []
    for i in range(nsec):
        dim = table.get_dim(i)
        if not twin_mask[i] or dim == 0:
            continue
        (dense_items if dim <= cfg.lanc_dim_threshold
         else lanc_items).append(i)

    _dense_buckets(cfg, table, dense_items, dense_builder, neigen, sl,
                   evals_by_sector, device)

    sector_times: List[Tuple] = []
    lanczos_stats: Dict[int, Tuple[int, int, int]] = {}
    for i in lanc_items:
        t0 = time.perf_counter()
        lanczos_stats[i] = _lanczos_solve_sector(
            cfg, table, i, matvec_builder, neigen[i], sl, evals_by_sector)
        sector_times.append((i, table.get_dim(i), len(evals_by_sector[i]),
                             time.perf_counter() - t0))
    if cfg.ed_verbose >= 3 and sector_times:
        print("[edipack_tpu_torch] per-sector Lanczos timings:")
        for i, d, nv, dt in sorted(sector_times, key=lambda t: -t[3])[:20]:
            print(f"  sector {i:4d} dim {d:>10d} nev {nv}  {dt:8.3f}s")
    return _finish(cfg, table, sl, evals_by_sector, neigen, twin_mask, nsec,
                   lanczos_stats)
