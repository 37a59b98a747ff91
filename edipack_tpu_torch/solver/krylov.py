"""Krylov (spread) complexity diagnostics; counterpart of
edipack_tpu.solver.krylov.

Parity target: reference ED_KRYLOV.f90 (krylov_state_complexity /
krylov_operator_complexity, :37-266): seed a Krylov chain with an excitation
of the T=0 ground state, tridiagonalize H on it, and measure the spread of
exp(-iHt)|seed> over the Krylov basis:
    phi(t) = U exp(-i E t) U† e_1   (T = U E U†, the Lanczos tridiagonal)
    K(t)   = Σ_n n |phi_n(t)|²       (complexity)
    S(t)   = -Σ_n p_n ln p_n         (spread entropy)
    P(n,t) = |phi_n(t)|²             (Krylov occupation distribution)

The state chains run on the solve's device through the solve's operator
routing (``result_matvec``: the fused kernel for dim >= 2^17 on the card).
The operator (Liouvillian) chains hold dense sector blocks on the same
device and refuse sectors above ``dense_dim_max``, as edipack_tpu does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.lanczos import lanczos_tridiag
from ..ops.sector_ops import spin_axis_op


@dataclass
class KrylovResult:
    times: np.ndarray                 # (Ltimes,)
    complexity: Dict[Tuple, np.ndarray]   # (op, ispin, iorb) -> K(t)
    entropy: Dict[Tuple, np.ndarray]
    distribution: Dict[Tuple, np.ndarray]  # (op,...) -> (m, Ltimes)


def _chain_evolution(alphas: np.ndarray, betas: np.ndarray,
                     times: np.ndarray):
    """phi_n(t) from the Lanczos chain; returns (m, Lt) probabilities."""
    m = len(alphas)
    t = np.diag(alphas)
    if m > 1:
        t += np.diag(betas[: m - 1], 1) + np.diag(betas[: m - 1], -1)
    ev, u = np.linalg.eigh(t)
    # phi(t) = U exp(-iEt) U† e1
    phase = np.exp(-1j * np.outer(ev, times))       # (m, Lt)
    phi = u @ (phase * u[0][:, None].conj())        # (m, Lt)
    return np.abs(phi) ** 2


def _builders(result):
    """A new set of the solve's operator builders (cached per sector)."""
    from .core import _normal_builders
    return _normal_builders(result.cfg, result.table, result.hloc,
                            result.um, result.bath, result.device)


def result_matvec(result, sec):
    """The matvec of ``sec`` that the solve of ``result`` would take (its
    routing: the fused operator or KronMatvec), built anew."""
    return _builders(result).matvec_builder(sec)


class _DirectSum:
    """H1 ⊕ H2 on the concatenation of two vectors, each part in its
    operator's own (internal) layout."""

    def __init__(self, mv1, mv2):
        self.mv1, self.mv2 = mv1, mv2
        self.dim = mv1.dim + mv2.dim

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        d1 = self.mv1.dim
        return torch.cat([self.mv1(v[:d1]), self.mv2(v[d1:])])


def _to_internal(mv, phi: torch.Tensor) -> torch.Tensor:
    conv = getattr(mv, "to_internal_flat", None)
    return conv(phi) if conv is not None else phi


def krylov_state_complexity(result, ops: List[str] = ("cdg", "c", "g1"),
                            m_max: int = 200) -> KrylovResult:
    """T=0 Krylov complexity of excitations of the ground state.

    ``result``: a SolveResult (normal mode). Ops: 'cdg', 'c', 'g1' = c†+c.
    """
    cfg = result.cfg
    if cfg.ed_mode != "normal":
        raise NotImplementedError("Krylov complexity: normal mode only "
                                  "(reference EDIPACK.f90:155-159 guard)")
    table = result.table
    sl = result.diag.state_list
    st = min(sl, key=lambda s: s.energy)
    sec = table.sector(st.sector)
    v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
    times = np.linspace(0.0, cfg.tmax, cfg.ltimes)
    # one operator per target sector for all the chains of this call
    matvec_of = _builders(result).matvec_builder

    out = KrylovResult(times, {}, {}, {})
    for ispin in range(cfg.nspin):
        axis = 2 if ispin == 0 else 1
        basis_src = sec.ups if ispin == 0 else sec.dws
        for iorb in range(cfg.norb):
            iud = iorb if not cfg.ed_total_ud else 0
            for op in ops:
                parts = []
                if op in ("cdg", "g1"):
                    jsec = table.cdg_sector(st.sector, ispin, iud)
                    if jsec is not None:
                        t = table.sector(jsec)
                        mp = spin_axis_op(basis_src,
                                          t.ups if ispin == 0 else t.dws,
                                          sec.ns, "cdg", iorb, axis)
                        parts.append((jsec, mp))
                if op in ("c", "g1"):
                    jsec = table.c_sector(st.sector, ispin, iud)
                    if jsec is not None:
                        t = table.sector(jsec)
                        mp = spin_axis_op(basis_src,
                                          t.ups if ispin == 0 else t.dws,
                                          sec.ns, "c", iorb, axis)
                        parts.append((jsec, mp))
                if not parts:
                    continue
                key = (op, ispin, iorb)
                # chains to run, each (seed in its operator's layout, op):
                # g1 = c† + c seeds ONE combined chain on the direct sum of
                # the two target sectors (the reference builds the combined
                # chain, ED_KRYLOV.f90:54-266). Each part goes to its own
                # operator's layout; the fused layout is a norm-preserving
                # permutation and padding, so the chain's α and β are those
                # of the original layout.
                chains = []
                if op == "g1" and len(parts) == 2:
                    (j1, mp1), (j2, mp2) = parts
                    mv1 = matvec_of(table.sector(j1))
                    mv2 = matvec_of(table.sector(j2))
                    phi = torch.cat([
                        _to_internal(mv1, mp1.apply(v3).reshape(-1)),
                        _to_internal(mv2, mp2.apply(v3).reshape(-1))])
                    chains.append((phi, _DirectSum(mv1, mv2),
                                   table.sector(j1).dim
                                   + table.sector(j2).dim))
                else:
                    for (jsec, mp) in parts:
                        tsec = table.sector(jsec)
                        mv = matvec_of(tsec)
                        chains.append((_to_internal(
                            mv, mp.apply(v3).reshape(-1)), mv, tsec.dim))
                ksum = np.zeros(len(times))
                ssum = np.zeros(len(times))
                dist = None
                wtot = 0.0
                for (phi, mv, dim_t) in chains:
                    norm = float(torch.linalg.norm(phi))
                    if norm < 1e-14:
                        continue
                    m = min(m_max, cfg.lanc_niter, max(2, dim_t))
                    alphas, betas, _ = lanczos_tridiag(mv, phi, m)
                    a = alphas.cpu().numpy()
                    b = betas.cpu().numpy()
                    k_eff = m
                    for i in range(m - 1):
                        if b[i] < 1e-13 * max(1.0, np.abs(a).max()):
                            k_eff = i + 1
                            break
                    p = _chain_evolution(a[:k_eff], b[:k_eff], times)
                    nvec = np.arange(p.shape[0])
                    w = norm ** 2
                    ksum += w * (nvec[:, None] * p).sum(0)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        s = -(p * np.where(p > 1e-300, np.log(p), 0.0)).sum(0)
                    ssum += w * s
                    if dist is None or p.shape[0] > dist.shape[0]:
                        dist = p
                    wtot += w
                if wtot > 0:
                    out.complexity[key] = ksum / wtot
                    out.entropy[key] = ssum / wtot
                    out.distribution[key] = dist
    return out


# ---------------------------------------------------------------------------
# Krylov OPERATOR complexity (Liouvillian chain)
# ---------------------------------------------------------------------------


class _OpVector:
    """Sector-blocked operator |O) = {(lsec, rsec): dense block}, the
    counterpart of the reference koc_vector_normal
    (ED_NORMAL/ED_KRYLOV_NORMAL.f90:23-32): blocks are dense device
    matrices, so the Liouvillian is two matmuls per block."""

    def __init__(self, blocks=None):
        self.blocks = blocks or {}

    def axpy(self, a, other):
        for k, m in other.blocks.items():
            self.blocks[k] = self.blocks.get(k, 0.0) + a * m

    def scale(self, a):
        for k in self.blocks:
            self.blocks[k] = a * self.blocks[k]


def _koc_inner(a: "_OpVector", b: "_OpVector", gs_by_sector) -> float:
    """T=0 Wightman product (A,B) = sum_gs 0.5 [<A gs|B gs> + <A†gs|B†gs>]
    (reference koc_inner_product_normal, ED_KRYLOV_NORMAL.f90:484-524)."""
    dot = 0.0
    for key, am in a.blocks.items():
        bm = b.blocks.get(key)
        if bm is None:
            continue
        l, r = key
        if r in gs_by_sector:
            for gs in gs_by_sector[r]:
                dot += 0.5 * float(torch.dot(am @ gs, bm @ gs))
        if l in gs_by_sector:
            for gs in gs_by_sector[l]:
                dot += 0.5 * float(torch.dot(am.T @ gs, bm.T @ gs))
    return dot


def krylov_operator_complexity(result, ops: List[str] = ("cdg", "c", "g1"),
                               m_max: int = 200,
                               dense_dim_max: int = 4096) -> KrylovResult:
    """T=0 Krylov-operator (Liouvillian) complexity of d†/d/γ1 =
    d† + d (reference krylov_operator_complexity, ED_KRYLOV.f90:54-137).

    The operator Krylov chain is built with L = [H, ·] acting on
    sector-blocked dense matrices; sectors larger than ``dense_dim_max``
    raise (the diagnostic targets small systems, as in the reference where
    blocks are sparse CSR with OpTol truncation)."""
    cfg = result.cfg
    if cfg.ed_mode != "normal":
        raise NotImplementedError("operator complexity: normal mode only")
    table = result.table
    dev = result.device
    f64 = dict(dtype=torch.float64, device=dev)
    sl = result.diag.state_list
    times = np.linspace(0.0, cfg.tmax, cfg.ltimes)
    out = KrylovResult(times, {}, {}, {})

    # ground-state multiplet, grouped by sector
    e0 = min(s.energy for s in sl)
    gs_by_sector: Dict[int, list] = {}
    for s in sl:
        if s.energy - e0 <= cfg.gs_threshold:
            gs_by_sector.setdefault(s.sector, []).append(
                s.vector.to(torch.float64))

    hcache: Dict[int, torch.Tensor] = {}

    def hblock(isec: int) -> torch.Tensor:
        if isec not in hcache:
            sec = table.sector(isec)
            if sec.dim > dense_dim_max:
                raise NotImplementedError(
                    f"operator complexity: sector dim {sec.dim} exceeds the "
                    f"dense-block limit {dense_dim_max}")
            from ..models.normal import build_normal_sector_op
            op = build_normal_sector_op(result.cfg, sec, result.hloc,
                                        result.um, result.bath)
            hcache[isec] = torch.as_tensor(op.to_dense(), **f64)
        return hcache[isec]

    def op_block(kind, iorb, ispin, lsec, rsec) -> torch.Tensor:
        """Dense matrix of c/cdg_{iorb,ispin}: rsec -> lsec."""
        sec_r = table.sector(rsec)
        sec_l = table.sector(lsec)
        axis = 2 if ispin == 0 else 1
        mp = spin_axis_op(sec_r.ups if ispin == 0 else sec_r.dws,
                          sec_l.ups if ispin == 0 else sec_l.dws,
                          sec_r.ns, kind, iorb, axis)
        # the map applied to every basis vector of rsec at once: column i
        # of the block is the image of e_i
        eye = torch.eye(sec_r.dim, **f64).reshape(
            sec_r.dim, sec_r.dim_ph, sec_r.dim_dw, sec_r.dim_up)
        src = torch.as_tensor(np.where(mp.src < 0, 0, mp.src),
                              dtype=torch.int64, device=dev)
        sign = torch.as_tensor(np.where(mp.src < 0, 0.0, mp.sign), **f64)
        shape = [1, 1, 1, 1]
        shape[axis + 1] = -1
        img = eye.index_select(axis + 1, src) * sign.view(shape)
        return img.reshape(sec_r.dim, sec_l.dim).T.contiguous()

    def seed(kind_pairs, iorb, ispin) -> "_OpVector":
        o = _OpVector()
        for isec in gs_by_sector:
            iud = iorb if not cfg.ed_total_ud else 0
            for kind in kind_pairs:
                up = table.cdg_sector(isec, ispin, iud) if kind == "cdg" \
                    else table.c_sector(isec, ispin, iud)
                dn = table.c_sector(isec, ispin, iud) if kind == "cdg" \
                    else table.cdg_sector(isec, ispin, iud)
                if up is not None:
                    key = (up, isec)
                    if key not in o.blocks:
                        o.blocks[key] = op_block(kind, iorb, ispin, *key)
                if dn is not None:
                    key = (isec, dn)
                    if key not in o.blocks:
                        o.blocks[key] = op_block(kind, iorb, ispin, *key)
        return o

    def liouville(a: "_OpVector") -> "_OpVector":
        w = _OpVector()
        for (l, r), m in a.blocks.items():
            w.blocks[(l, r)] = hblock(l) @ m - m @ hblock(r)
        return w

    for ispin in range(cfg.nspin):
        for iorb in range(cfg.norb):
            for op in ops:
                kinds = {"cdg": ("cdg",), "c": ("c",),
                         "g1": ("cdg", "c")}[op]
                q = seed(kinds, iorb, ispin)
                norm2 = _koc_inner(q, q, gs_by_sector)
                if norm2 <= 0:
                    continue
                q.scale(1.0 / np.sqrt(norm2))
                alphas, betas = [], []
                qprev, beta_prev = None, 0.0
                nmax = min(m_max, cfg.lanc_ngfiter)
                for n in range(nmax):
                    w = liouville(q)
                    a_n = _koc_inner(q, w, gs_by_sector)
                    alphas.append(a_n)
                    w.axpy(-a_n, q)
                    if qprev is not None:
                        w.axpy(-beta_prev, qprev)
                    wn = _koc_inner(w, w, gs_by_sector)
                    if wn <= 1e-24:
                        break
                    beta = np.sqrt(wn)
                    betas.append(beta)
                    qprev, q = q, w
                    q.scale(1.0 / beta)
                    beta_prev = beta
                a = np.asarray(alphas)
                b = np.asarray(betas)
                p = _chain_evolution(a, b[: len(a) - 1], times)
                nvec = np.arange(p.shape[0])
                key = (op, ispin, iorb)
                out.complexity[key] = (nvec[:, None] * p).sum(0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    out.entropy[key] = -(p * np.where(p > 1e-300,
                                                      np.log(p), 0.0)).sum(0)
                out.distribution[key] = p
    return out
