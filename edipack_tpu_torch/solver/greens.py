"""Normal-mode impurity Green's functions via Krylov continued fractions.

Parity target: reference ED_GF_NORMAL.f90 (build_impG_normal :68+,
add_to_lanczos_gf_normal :363-427, off-diagonal reconstruction :540-563,
get_impG :496-607, get_Sigma :698-739) and the GFmatrix store
(ED_GFMATRIX.f90:26-55); counterpart of edipack_tpu.solver.greens.

For every retained eigenstate and excitation operator O: |φ> = O|ψ> on the
device, then the exact dense eigenbasis of a small target sector or a
Lanczos tridiagonalization of a large one gives Källén-Lehmann
weights/poles. |φ> keeps its state's dtype (f32 for a Lanczos state of an
``ed_precision="float32"`` solve, f64 for a dense-bucket state); each chain
runs in that dtype through the target sector's operator, which promotes or
casts as its edipack_tpu counterpart does. Through an operator split over
a mesh of ranks (``matvec.mesh``), |φ> is built whole on every rank from
the whole state and its chain runs on this rank's rows of it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bath.functions import _block_inv
from ..config import EDConfig
from ..ops.lanczos import (apply_full, lanczos_tridiag,
                           lanczos_tridiag_batch)
from ..ops.sector_ops import spin_axis_op
from ..sectors import Sector, SectorTable
from .eigenspace import StateList

# bytes of the live vectors of one batched GF launch (about 4 a chain, 16
# bytes an element): edipack_tpu's chunk bound, so that the chunks match
GF_BATCH_BYTES = 1 << 28
# a test hook: False runs every GF chain one at a time (the same moments,
# another order of sums)
BATCH_CHAINS = True


@dataclass
class GFMatrix:
    """Flat Källén-Lehmann store: channel key -> (weights, poles) with the
    state Boltzmann weights folded in. G_key(z) = Σ_n w_n / (z - p_n)."""
    channels: Dict[Tuple, List[Tuple[np.ndarray, np.ndarray]]] = field(
        default_factory=dict)

    def add(self, key: Tuple, weights: np.ndarray, poles: np.ndarray) -> None:
        self.channels.setdefault(key, []).append(
            (np.asarray(weights, dtype=complex), np.asarray(poles, float)))

    def packed(self, key: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        if key not in self.channels:
            return np.zeros(0, complex), np.zeros(0)
        ws = np.concatenate([w for w, _ in self.channels[key]])
        ps = np.concatenate([p for _, p in self.channels[key]])
        return ws, ps

    def eval(self, key: Tuple, z: np.ndarray) -> np.ndarray:
        w, p = self.packed(key)
        z = np.atleast_1d(np.asarray(z, complex))
        if len(w) == 0:
            return np.zeros(len(z), complex)
        den = z[:, None] - p[None, :]
        # exact z == pole hits: exclude the singular terms
        sing = den == 0
        if np.any(sing):
            den = np.where(sing, 1.0, den)
            return (np.where(sing, 0.0, w[None, :]) / den).sum(axis=1)
        return (w[None, :] / den).sum(axis=1)

    def eval_tau(self, key: Tuple, tau: np.ndarray, beta: float
                 ) -> np.ndarray:
        """Fermionic imaginary-time evaluation on 0 <= tau <= beta:
        G(tau) = -Σ_n w_n e^{-tau p_n} / (1 + e^{-beta p_n}), computed in
        the overflow-stable logaddexp form."""
        w, p = self.packed(key)
        tau = np.atleast_1d(np.asarray(tau, float))
        if len(w) == 0:
            return np.zeros(len(tau))
        ex = -np.logaddexp(tau[:, None] * p[None, :],
                           (tau[:, None] - beta) * p[None, :])
        return -(np.real(w)[None, :] * np.exp(ex)).sum(axis=1)

    # -- persistence (reference write/read_GFmatrix, ED_GFMATRIX.f90:78-107):
    # one npz, two arrays per channel named repr(key) + "|w" / "|p", the
    # layout edipack_tpu writes and reads
    def save(self, path: str) -> None:
        payload = {}
        for key, lst in self.channels.items():
            skey = repr(key)
            payload[skey + "|w"] = np.concatenate([w for w, _ in lst])
            payload[skey + "|p"] = np.concatenate([p for _, p in lst])
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str) -> "GFMatrix":
        from ast import literal_eval
        gf = cls()
        with np.load(path) as data:
            for name in data.files:
                if name.endswith("|w"):
                    gf.add(literal_eval(name[:-2]), data[name],
                           data[name[:-2] + "|p"])
        return gf


def _dense_moments(h: np.ndarray, phi: np.ndarray):
    evals, evecs = np.linalg.eigh(h)
    w = np.abs(evecs.conj().T @ phi) ** 2
    keep = w > 1e-16 * max(w.max(), 1e-300)
    return w[keep], evals[keep]


def _moments_from_phi(matvec, phi: torch.Tensor, m: int, dense_eig=None):
    """Excitation moments: returns (weights, excitation energies E_n).

    dense_eig = (evals, evecs) exact eigenbasis of the target sector when
    available (small sectors); otherwise a Lanczos tridiagonalization on
    the device and a host eigh of the small tridiagonal matrix. A weight
    is |<n|φ>|², with the conjugate of a complex eigenbasis."""
    if dense_eig is not None:
        evals, evecs = dense_eig
        # an f32 excitation is promoted to the f64 / c128 eigenbasis, as
        # JAX promotes
        dt = torch.promote_types(evecs.dtype, phi.dtype)
        w = ((evecs.to(dt).conj().T @ phi.to(dt)).abs() ** 2).cpu().numpy()
        keep = w > 1e-16 * max(w.max(), 1e-300)
        return w[keep], np.asarray(evals)[keep]
    dim = phi.shape[0]
    fused = hasattr(matvec, "to_internal_flat")
    if dim <= 128:
        # tiny target sector: exact moments via the materialized H
        eye = torch.eye(dim, dtype=phi.dtype, device=phi.device)
        if fused:
            cols = [matvec.from_internal_flat(apply_full(
                matvec, matvec.to_internal_flat(eye[i])))
                for i in range(dim)]
        else:
            cols = [apply_full(matvec, eye[i]) for i in range(dim)]
        h = torch.stack(cols, dim=1).cpu().numpy()
        return _dense_moments(h, phi.cpu().numpy())
    m = max(2, m)
    if fused:
        # fused matvec: the Krylov chain runs in the padded internal
        # layout (a norm-preserving permutation + padding)
        phi = matvec.to_internal_flat(phi)
    mesh = getattr(matvec, "mesh", None)
    if mesh is not None:
        phi = matvec.local(phi)
    alphas, betas, norm0 = lanczos_tridiag(matvec, phi, m, mesh)
    return _tridiag_moments(alphas.cpu().numpy(), betas.cpu().numpy(),
                            float(norm0), m)


def _tridiag_moments(a: np.ndarray, b: np.ndarray, n0: float, m: int):
    """Weights and energies of one chain's (alphas, betas, norm0), the
    tridiagonal truncated at breakdown and solved on the host."""
    if n0 < 1e-15:
        return np.zeros(0), np.zeros(0)
    k = m
    for i in range(m - 1):
        if b[i] < 1e-13 * max(1.0, np.abs(a).max()):
            k = i + 1
            break
    t = np.diag(a[:k])
    if k > 1:
        t += np.diag(b[:k - 1], 1) + np.diag(b[:k - 1], -1)
    tv, tu = np.linalg.eigh(t)
    return (n0 ** 2) * np.abs(tu[0, :]) ** 2, tv


def _moments_from_phis(matvec, phis: List[torch.Tensor], m: int):
    """Moments of several start vectors in the SAME target sector
    (edipack_tpu.solver.greens._moments_from_phis): the chains run together
    through an operator that takes a (B, dim) block (``batched``), in
    chunks of at most ``GF_BATCH_BYTES`` of live vectors; one after the
    other through the others (B1/B2's fused operators) and when there is
    one φ. The (B, m) tridiagonals are solved on the host."""
    m = max(2, m)
    if len(phis) == 1 or not (BATCH_CHAINS
                              and getattr(matvec, "batched", False)):
        return [_moments_from_phi(matvec, phi, m) for phi in phis]
    to_internal = getattr(matvec, "to_internal_flat", None)
    dim = phis[0].numel()
    max_b = max(2, GF_BATCH_BYTES // max(1, 4 * dim * 16))
    out = []
    for lo in range(0, len(phis), max_b):
        chunk = [p.reshape(-1) for p in phis[lo:lo + max_b]]
        if len(chunk) == 1:
            out.append(_moments_from_phi(matvec, chunk[0], m))
            continue
        if to_internal is not None:
            chunk = [to_internal(p) for p in chunk]
        v0s = torch.stack(chunk)    # mixed dtypes promote, as in jnp.stack
        mesh = getattr(matvec, "mesh", None)
        if mesh is None:
            alphas, betas, norm0s = lanczos_tridiag_batch(matvec, v0s, m)
        else:
            alphas, betas, norm0s = lanczos_tridiag_batch(
                matvec, matvec.local(v0s), m, mesh=mesh)
        a, b = alphas.cpu().numpy(), betas.cpu().numpy()
        n0 = norm0s.cpu().numpy()
        out.extend(_tridiag_moments(a[i], b[i], float(n0[i]), m)
                   for i in range(len(chunk)))
    return out


def build_gf_normal(cfg: EDConfig, table: SectorTable, sl: StateList,
                    matvec_builder: Callable[[Sector], object],
                    dense_eig_cache: Callable[[int], Optional[Tuple]]
                    ) -> GFMatrix:
    """Normal-mode impurity GF. Channel keys ('g', ispin, a, b) for
    G_ab^s; weights folded with state weights. Off-diagonal components come
    from the symmetrized combination (reference :540-563)."""
    gf = GFMatrix()
    weights = sl.boltzmann_weights()
    norb, nspin = cfg.norb, cfg.nspin
    per_orbital_qn = not cfg.ed_total_ud
    offdiag = (cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal") \
        and not per_orbital_qn
    aux = GFMatrix()   # (a+b) channels for the off-diagonal reconstruction

    # Lanczos channels are gathered per target sector; items:
    # (store, key, phi, wstate, sgn, ei)
    pending: Dict[int, list] = {}
    for istate, st in enumerate(sl):
        wstate = weights[istate]
        isec = st.sector
        sec = table.sector(isec)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        ei = st.energy
        for ispin in range(nspin):
            axis = 2 if ispin == 0 else 1
            basis_src = sec.ups if ispin == 0 else sec.dws
            # particle (c†) and hole (c) target sectors
            for sgn_kind, kind in ((+1, "cdg"), (-1, "c")):
                jsec_of = {}
                for a in range(norb):
                    iud = a if per_orbital_qn else 0
                    jsec_of[a] = (table.cdg_sector(isec, ispin, iud)
                                  if kind == "cdg"
                                  else table.c_sector(isec, ispin, iud))
                phis = {}
                for a in range(norb):
                    if jsec_of[a] is None:
                        continue
                    tsec = table.sector(jsec_of[a])
                    basis_tgt = tsec.ups if ispin == 0 else tsec.dws
                    amap = spin_axis_op(basis_src, basis_tgt, sec.ns, kind, a,
                                        axis)
                    phis[a] = amap.apply(v3).reshape(-1)
                combos = [(a, a) for a in range(norb) if a in phis]
                if offdiag:
                    combos += [(a, b) for a in range(norb)
                               for b in range(a + 1, norb)
                               if a in phis and b in phis]
                for (a, b) in combos:
                    phi = phis[a] if a == b else (phis[a] + phis[b])
                    jsec = jsec_of[a]
                    dense_eig = dense_eig_cache(jsec)
                    key = ("g", ispin, a, b) if a == b \
                        else ("aux", ispin, a, b)
                    store = gf if a == b else aux
                    if dense_eig is not None:
                        w, en = _moments_from_phi(None, phi, 2,
                                                  dense_eig=dense_eig)
                        if len(w):
                            store.add(key, wstate * w, sgn_kind * (en - ei))
                    else:
                        pending.setdefault(jsec, []).append(
                            (store, key, phi, wstate, sgn_kind, ei))

    for jsec, items in pending.items():
        tsec = table.sector(jsec)
        mv = matvec_builder(tsec)
        m = min(cfg.lanc_ngfiter, max(2, tsec.dim))
        res = _moments_from_phis(mv, [it[2] for it in items], m)
        for (store, key, _, wstate, sgn_kind, ei), (w, en) in zip(items, res):
            if len(w):
                store.add(key, wstate * w, sgn_kind * (en - ei))

    # phonon displacement propagator channel (reference
    # lanc_build_gf_phonon_main, ED_GF_NORMAL.f90:278-345): X = b + b†
    # applied within the SAME sector
    if cfg.nph > 0:
        from ..models.normal import _phonon_matrices
        _, x = _phonon_matrices(cfg)
        ph_pending: Dict[int, list] = {}
        for istate, st in enumerate(sl):
            sec = table.sector(st.sector)
            v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
            xt = torch.as_tensor(x, dtype=v3.dtype, device=v3.device)
            phi = torch.einsum("pq,qdu->pdu", xt, v3).reshape(-1)
            dense_eig = dense_eig_cache(st.sector)
            if dense_eig is not None:
                wts, en = _moments_from_phi(None, phi, 2, dense_eig=dense_eig)
                if len(wts):
                    gf.add(("ph",), weights[istate] * wts, en - st.energy)
            else:
                ph_pending.setdefault(st.sector, []).append(
                    (phi, weights[istate], st.energy))
        for jsec, items in ph_pending.items():
            tsec = table.sector(jsec)
            mv = matvec_builder(tsec)
            m = min(cfg.lanc_ngfiter, max(2, tsec.dim))
            res = _moments_from_phis(mv, [p for p, _, _ in items], m)
            for (_, wstate, e0), (wts, en) in zip(items, res):
                if len(wts):
                    gf.add(("ph",), wstate * wts, en - e0)

    # off-diagonal reconstruction: G_ab = (aux - G_aa - G_bb)/2
    if offdiag:
        for ispin in range(nspin):
            for a in range(norb):
                for b in range(a + 1, norb):
                    key = ("aux", ispin, a, b)
                    if key not in aux.channels:
                        continue
                    wA, pA = aux.packed(key)
                    waa, paa = gf.packed(("g", ispin, a, a))
                    wbb, pbb = gf.packed(("g", ispin, b, b))
                    w = np.concatenate([0.5 * wA, -0.5 * waa, -0.5 * wbb])
                    p = np.concatenate([pA, paa, pbb])
                    gf.add(("g", ispin, a, b), w, p)
                    gf.add(("g", ispin, b, a), w, p)
    return gf


def eval_gf_normal(cfg: EDConfig, gf: GFMatrix, z) -> np.ndarray:
    """G(z): (Nspin,Nspin,Norb,Norb,Lz) (spin-diagonal in normal mode)."""
    z = np.atleast_1d(np.asarray(z, complex))
    ns, no = cfg.nspin, cfg.norb
    out = np.zeros((ns, ns, no, no, len(z)), complex)
    for s in range(ns):
        for a in range(no):
            for b in range(no):
                out[s, s, a, b] = gf.eval(("g", s, a, b), z)
    return out


def eval_dimp(cfg: EDConfig, gf: GFMatrix, z, axis: str = "m") -> np.ndarray:
    """Phonon propagator D(z) with enforced spectral symmetry
    (reference get_impD_normal, ED_GF_NORMAL.f90:611-690)."""
    z = np.atleast_1d(np.asarray(z, complex))
    out = np.zeros(len(z), complex)
    w, p = gf.packed(("ph",))
    beta = cfg.beta
    for peso, de in zip(np.real(w), p):
        if abs(beta * de) < 1e-8:
            if axis.startswith("m"):
                out[np.abs(z) < 1e-10] -= peso * beta
            else:
                out[np.abs(np.real(z)) < 1e-10] += peso * beta
        elif de > 0:
            f = peso * (1.0 - np.exp(-beta * de))
            if axis.startswith("m"):
                out -= f * 2 * de / (np.imag(z) ** 2 + de ** 2)
            else:
                out += f * (1.0 / (z - de) - 1.0 / (z + de))
    return out


def sigma_normal(cfg: EDConfig, gf_eval: np.ndarray,
                 invg0: np.ndarray) -> np.ndarray:
    """Σ = G0⁻¹ - G⁻¹ (reference get_Sigma_normal :698-739)."""
    return invg0 - _block_inv(gf_eval)
