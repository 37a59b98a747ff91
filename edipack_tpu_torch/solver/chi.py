"""Susceptibilities (normal mode; reference ED_CHI_FUNCTIONS.f90 guard
:57-85); counterpart of edipack_tpu.solver.chi.build_chi_normal.

Parity targets: ED_NORMAL/ED_CHI_SPIN/DENS/PAIR/EXCT. For a Hermitian
operator O (spin Sz_a, density n_a) and eigenstate |ψ>:
  χ_O(z) = Σ_n |<n|O|ψ>|² [ 1/(z - (En-Ei)) - 1/(z + (En-Ei)) ]
(both ± poles, reference lanc_ed_build_spinChi). Pair χ uses O = c_a↑ c_a↓
(non-Hermitian; particle/hole channels like the GF). Every operator is a
diagonal scaling or an axis gather of the state tensor V[ph, dw, up] on the
solve's device, in the state's dtype; the Lanczos chains of a target
sector run through the solve's ``matvec_builder`` (the fused kernel B1/B2
for dim >= 2^17 on the card), as the GF chains do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EDConfig
from ..fock import hop_elements, occupations
from ..ops.sector_ops import spin_axis_op
from ..sectors import SectorTable
from .eigenspace import StateList
from .greens import GFMatrix, _moments_from_phi, _moments_from_phis


def _diag_op_apply(v3: torch.Tensor, diag_up: np.ndarray,
                   diag_dw: np.ndarray) -> torch.Tensor:
    """Apply a density-like operator d_up(n_up) + d_dw(n_dw), diagonal in
    the occupation basis, to the state tensor."""
    du = torch.as_tensor(diag_up, dtype=v3.dtype, device=v3.device)
    dd = torch.as_tensor(diag_dw, dtype=v3.dtype, device=v3.device)
    return v3 * (du[None, None, :] + dd[None, :, None])


def _hop_axis_apply(v3: torch.Tensor, basis: np.ndarray, ns: int, a: int,
                    b: int, axis: int) -> torch.Tensor:
    """Apply c†_a c_b (within-sector hop) along one spin axis."""
    rows, cols, signs = hop_elements(np.asarray(basis), ns, a, b)
    src = np.full(len(basis), -1, np.int64)
    sgn = np.zeros(len(basis))
    src[rows] = cols
    sgn[rows] = signs
    idx = torch.as_tensor(np.where(src < 0, 0, src), dtype=torch.int64,
                          device=v3.device)
    s = torch.as_tensor(np.where(src < 0, 0.0, sgn), dtype=v3.dtype,
                        device=v3.device)
    shape = [1, 1, 1]
    shape[axis] = -1
    return v3.index_select(axis, idx) * s.view(shape)


def build_chi_normal(cfg: EDConfig, table: SectorTable, sl: StateList,
                     matvec_builder, dense_eig_cache) -> GFMatrix:
    chi = GFMatrix()
    w = sl.boltzmann_weights()
    norb = cfg.norb
    ns = table.dims.ns

    # Lanczos channels queue per target sector and run after the state
    # loop, sector by sector (as the GF builder does); items: (phi, cb).
    # Every callback binds its state's weight and energy, and its channel's
    # key, through default arguments, so that a callback run after the loop
    # moved on still adds to its own channel with its own state's numbers.
    pending = {}

    def _enqueue(jsec, phi, cb):
        de = dense_eig_cache(jsec)
        if de is not None:
            wts, en = _moments_from_phi(None, phi.reshape(-1), 2,
                                        dense_eig=de)
            cb(wts, en)
        else:
            pending.setdefault(jsec, []).append((phi.reshape(-1), cb))

    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        ei = st.energy
        occ_u = occupations(sec.ups, ns).astype(float)[:, :norb]
        occ_d = occupations(sec.dws, ns).astype(float)[:, :norb]

        def hermitian_channel(key, phi, _w=w[ist], _ei=ei, _isec=st.sector):
            def cb(wts, en, _w=_w, _ei=_ei, key=key):
                if len(wts) == 0:
                    return
                de = en - _ei
                # χ(z) = Σ w [1/(z - dE) - 1/(z + dE)]; at dE=0 the two
                # poles cancel for z≠0 and give the Curie (static) part.
                chi.add(key, np.concatenate([_w * wts, -_w * wts]),
                        np.concatenate([de, -de]))
            _enqueue(_isec, phi, cb)

        if cfg.chispin_flag:
            for a in range(norb):
                phi = _diag_op_apply(v3, 0.5 * occ_u[:, a],
                                     -0.5 * occ_d[:, a])
                hermitian_channel(("spin", a, a), phi)
            # off-diagonal via (Sz_a + Sz_b) combination
            for a in range(norb):
                for b in range(a + 1, norb):
                    phi = _diag_op_apply(
                        v3, 0.5 * (occ_u[:, a] + occ_u[:, b]),
                        -0.5 * (occ_d[:, a] + occ_d[:, b]))
                    hermitian_channel(("spin_aux", a, b), phi)
        if cfg.chidens_flag:
            for a in range(norb):
                phi = _diag_op_apply(v3, occ_u[:, a], occ_d[:, a])
                hermitian_channel(("dens", a, a), phi)
            for a in range(norb):
                for b in range(a + 1, norb):
                    phi = _diag_op_apply(v3, occ_u[:, a] + occ_u[:, b],
                                         occ_d[:, a] + occ_d[:, b])
                    hermitian_channel(("dens_aux", a, b), phi)
        if cfg.chipair_flag:
            per_orb = not cfg.ed_total_ud
            for a in range(norb):
                iud = a if per_orb else 0
                # "lesser" O = c_a↑ c_a↓ -> poles +dE (ED_CHI_PAIR.f90:128-140)
                jsec = table.c_sector(st.sector, 0, iud)
                jsec2 = table.c_sector(jsec, 1, iud) \
                    if jsec is not None else None
                if jsec2 is not None:
                    tsec = table.sector(jsec2)
                    mid = table.sector(jsec)
                    m1 = spin_axis_op(sec.ups, mid.ups, ns, "c", a, 2)
                    m2 = spin_axis_op(mid.dws, tsec.dws, ns, "c", a, 1)
                    _enqueue(jsec2, m2.apply(m1.apply(v3)),
                             lambda wts, en, _w=w[ist], _ei=ei, a=a:
                             chi.add(("pair", a, a), _w * wts, en - _ei)
                             if len(wts) else None)
                # "greater" c†_a↓ c†_a↑ -> poles -dE (:145-155)
                ksec = table.cdg_sector(st.sector, 0, iud)
                ksec2 = table.cdg_sector(ksec, 1, iud) \
                    if ksec is not None else None
                if ksec2 is not None:
                    tsec = table.sector(ksec2)
                    mid = table.sector(ksec)
                    m1 = spin_axis_op(sec.ups, mid.ups, ns, "cdg", a, 2)
                    m2 = spin_axis_op(mid.dws, tsec.dws, ns, "cdg", a, 1)
                    _enqueue(ksec2, m2.apply(m1.apply(v3)),
                             lambda wts, en, _w=w[ist], _ei=ei, a=a:
                             chi.add(("pair", a, a), _w * wts, -(en - _ei))
                             if len(wts) else None)

        if cfg.chiexct_flag and norb > 1 and cfg.ed_total_ud:
            # exciton susceptibilities (ED_CHI_EXCT.f90): for a<b
            #   singlet  E_S  = Σ_σ c†_{aσ} c_{bσ}         (within sector)
            #   triplet0 E_Tz = Σ_σ σ c†_{aσ} c_{bσ}       (within sector)
            #   triplet± flip: c†_{a,dw} c_{b,up} etc.     (±1 spin-flip sector)
            # each as lesser (O, +dE) / greater (O†, -dE) channels
            def bilinear_within(a, b, s_up, s_dw):
                return s_up * _hop_axis_apply(v3, sec.ups, ns, a, b, 2) \
                    + s_dw * _hop_axis_apply(v3, sec.dws, ns, a, b, 1)

            for a in range(norb):
                for b in range(a + 1, norb):
                    for key, s_dw in (("exct_s", 1.0), ("exct_tz", -1.0)):
                        phi_l = bilinear_within(a, b, 1.0, s_dw)
                        phi_g = bilinear_within(b, a, 1.0, s_dw)
                        for phi, sgn in ((phi_l, +1), (phi_g, -1)):
                            _enqueue(st.sector, phi,
                                     lambda wts, en, _w=w[ist], _ei=ei,
                                     key=key, a=a, b=b, sgn=sgn:
                                     chi.add((key, a, b), _w * wts,
                                             sgn * (en - _ei))
                                     if len(wts) else None)
                    # spin-flip (triplet Tx/Ty-like): c†_{a,dw} c_{b,up}
                    ks = table.c_sector(st.sector, 0)
                    js = table.cdg_sector(ks, 1) if ks is not None else None
                    if js is not None:
                        tsec = table.sector(js)
                        mid = table.sector(ks)
                        m1 = spin_axis_op(sec.ups, mid.ups, ns, "c", b, 2)
                        m2 = spin_axis_op(mid.dws, tsec.dws, ns, "cdg", a, 1)
                        _enqueue(js, m2.apply(m1.apply(v3)),
                                 lambda wts, en, _w=w[ist], _ei=ei, a=a, b=b:
                                 chi.add(("exct_t", a, b), _w * wts,
                                         en - _ei)
                                 if len(wts) else None)
                    ks = table.c_sector(st.sector, 1)
                    js = table.cdg_sector(ks, 0) if ks is not None else None
                    if js is not None:
                        tsec = table.sector(js)
                        mid = table.sector(ks)
                        m1 = spin_axis_op(sec.dws, mid.dws, ns, "c", b, 1)
                        # axis 0 + 2, as edipack_tpu passes it
                        m2 = spin_axis_op(mid.ups, tsec.ups, ns, "cdg", a,
                                          0 + 2)
                        _enqueue(js, m2.apply(m1.apply(v3)),
                                 lambda wts, en, _w=w[ist], _ei=ei, a=a, b=b:
                                 chi.add(("exct_t", a, b), _w * wts,
                                         -(en - _ei))
                                 if len(wts) else None)

    for jsec, items in pending.items():
        tsec = table.sector(jsec)
        mvt = matvec_builder(tsec)
        mt = min(cfg.lanc_ngfiter, max(2, tsec.dim))
        res = _moments_from_phis(mvt, [p for p, _ in items], mt)
        for (_, cb), (wts, en) in zip(items, res):
            cb(wts, en)

    # reconstruct symmetric off-diagonals: χ_ab = (χ_aux - χ_aa - χ_bb)/2
    for kind in ("spin", "dens"):
        for a in range(norb):
            for b in range(a + 1, norb):
                key = (f"{kind}_aux", a, b)
                if key not in chi.channels:
                    continue
                wA, pA = chi.packed(key)
                waa, paa = chi.packed((kind, a, a))
                wbb, pbb = chi.packed((kind, b, b))
                wab = np.concatenate([0.5 * wA, -0.5 * waa, -0.5 * wbb])
                pab = np.concatenate([pA, paa, pbb])
                chi.add((kind, a, b), wab, pab)
                chi.add((kind, b, a), wab, pab)
    return chi
