"""superc / nonsu2 end-to-end solve on joint sector bases, in complex128
on the solve's device (counterpart of edipack_tpu.solver.core_joint).

Parity targets: reference ED_SUPERC/ (ED_DIAG_SUPERC, ED_GF_SUPERC
channels/reconstruction :130-361,640-780, get_Sigma_superc :938-1018,
ED_OBSERVABLES_SUPERC op :200-250) and ED_NONSU2/ equivalents.

Routing of a sector's matvec (as edipack_tpu's off-TPU branch):
  * ``ed_joint_kron="always"``   — JointKronMatvec (blocked Kron) for Sz
    and Ntot sectors;
  * else ``ed_sparse_h=False``   — JointMatvecDirect (COO scatter-add);
  * else                          — JointMatvec (padded ELL), which is what
    ``"auto"`` means off the TPU.
Under a mesh of ranks (parallel.mesh), a sector of dim >
4·lanc_dim_threshold (the JAX package's rule) is split: the blocked Kron
as ShardedJointKronMatvec (every block's dw rows), the ELL as
ShardedJointMatvec (its electronic rows). The direct operator stays whole
on every rank, as in the JAX package.

GF channel bookkeeping (GFMatrix keys):
  superc: ('g',a,a) up-diag, ('barg',a) dw-diag (Nambu 22), ('gaux',a,b)
          (c†a+c†b)/(c†a+ic†b) combos, ('faux',a,b) (c†a↑+cb↓) combos;
          reconstruction G_ab = (aux - (1-i)(Gaa+Gbb))/2,
          F_ab = (faux - (1-i)(Gaa + barG_bb))/2 (reference :750-770).
  nonsu2: ('g',(s,a),(s,a)) diag, ('gaux',(s1,a),(s2,b)) combos with the
          same polarization identity.

The excitations |φ> = O|ψ> and the Lanczos chains run on the device; the
observables are host NumPy contractions of each kept state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..bath.dmft_bath import DmftBath
from ..config import EDConfig
from ..device import PhaseTimer
from ..fock import occupations
from ..models.joint import (JointSectorOp, JointTermAccumulator,
                            build_joint_sector_op)
from ..ops.matvec import JointMatvec, JointMatvecDirect, ShardedJointMatvec
from ..parallel.mesh import shard_joint
from ..ops.sector_ops import joint_op
from ..sectors import Sector, SectorTable
from ..umatrix import SPIN_UP, SPIN_DW, Umatrix
from .diag import diagonalize
from .eigenspace import StateList
from .greens import GFMatrix, _moments_from_phi, _moments_from_phis
from .observables import Observables


def _lincomb_phi(v2: torch.Tensor, maps, coeffs) -> torch.Tensor:
    """Σ_k coeff_k O_k applied along the electronic axis of (dim_ph,
    dim_el)."""
    out = None
    for m, c in zip(maps, coeffs):
        t = m.apply(v2) * c
        out = t if out is None else out + t
    return out


class _GfHarvester:
    """Shared moment machinery for the joint-mode GF passes.

    Dense-eig sectors resolve immediately; Lanczos channels are queued and
    flushed grouped by target sector: the chains against one operator run
    together, as one batched chain (greens._moments_from_phis)."""

    def __init__(self, cfg, table, matvec_builder, dense_eig_cache):
        self.cfg = cfg
        self.table = table
        self.matvec_builder = matvec_builder
        self.dense_eig_cache = dense_eig_cache
        self._pending = {}

    def add_channel(self, store, key, jsec, phi, wfac, sgn, ei):
        dense_eig = self.dense_eig_cache(jsec)
        if dense_eig is not None:
            wts, en = _moments_from_phi(None, phi.reshape(-1), 2,
                                        dense_eig=dense_eig)
            if len(wts):
                store.add(key, wfac * wts, sgn * (en - ei))
            return
        self._pending.setdefault(jsec, []).append(
            (store, key, phi.reshape(-1), wfac, sgn, ei))

    def flush(self):
        for jsec, items in self._pending.items():
            tsec = self.table.sector(jsec)
            mv = self.matvec_builder(tsec)
            m = min(self.cfg.lanc_ngfiter, max(2, tsec.dim))
            res = _moments_from_phis(mv, [p for (_, _, p, _, _, _) in items],
                                     m)
            for (store, key, _, wfac, sgn, ei), (wts, en) in zip(items, res):
                if len(wts):
                    store.add(key, wfac * wts, sgn * (en - ei))
        self._pending = {}


def _phonon_gf_channels(cfg: EDConfig, table: SectorTable, sl: StateList,
                        H: _GfHarvester, gf: GFMatrix) -> None:
    """Phonon displacement propagator D(z) channel for the joint modes:
    X = b + b† applied within the same sector (reference
    lanc_build_gf_phonon_main, ED_SUPERC/ED_GF_SUPERC.f90:366-419, nonsu2
    equivalent via get_impD_nonsu2 dispatch ED_GREENS_FUNCTIONS.f90:140-158;
    the normal-mode twin lives in greens.build_gf_normal)."""
    if cfg.nph == 0:
        return
    from ..models.normal import _phonon_matrices
    _, x = _phonon_matrices(cfg)
    w = sl.boltzmann_weights()
    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v2 = st.vector.reshape(sec.dim_ph, sec.dim_el)
        phi = torch.as_tensor(x, dtype=v2.dtype, device=v2.device) @ v2
        H.add_channel(gf, ("ph",), st.sector, phi, w[ist], +1, st.energy)


def build_gf_superc(cfg: EDConfig, table: SectorTable, sl: StateList,
                    matvec_builder, dense_eig_cache) -> GFMatrix:
    gf = GFMatrix()
    w = sl.boltzmann_weights()
    norb = cfg.norb
    ns = table.dims.ns
    H = _GfHarvester(cfg, table, matvec_builder, dense_eig_cache)
    offdiag = cfg.bath_type != "normal" or cfg.ed_solve_offdiag_gf

    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v2 = st.vector.reshape(sec.dim_ph, sec.dim_el)
        ei = st.energy

        def channel(key, jsec, maps, coeffs, prefactor, sgn):
            if jsec is None:
                return
            tsec = table.sector(jsec)
            ms = [joint_op(sec.states, tsec.states, ns, kind, lvl, spin)
                  for (kind, lvl, spin) in maps]
            phi = _lincomb_phi(v2, ms, coeffs)
            H.add_channel(gf, key, jsec, phi, w[ist] * prefactor, sgn, ei)

        up = SPIN_UP
        dw = SPIN_DW
        for a in range(norb):
            jp = table.cdg_sector(st.sector, up)   # sz+1
            jm = table.c_sector(st.sector, up)     # sz-1
            channel(("g", a, a), jp, [("cdg", a, up)], [1.0], 1.0, +1)
            channel(("g", a, a), jm, [("c", a, up)], [1.0], 1.0, -1)
            # barG: dw channels (reference Gdiag ichan=2)
            jbp = table.c_sector(st.sector, dw)    # removing dw: sz+1
            jbm = table.cdg_sector(st.sector, dw)  # adding dw: sz-1
            channel(("barg", a), jbp, [("c", a, dw)], [1.0], 1.0, +1)
            channel(("barg", a), jbm, [("cdg", a, dw)], [1.0], 1.0, -1)
        if offdiag:
            # every ordered pair (a,b): G_ab(z) and G_ba(z) are distinct
            # functions on the Matsubara axis (reference hybrid/replica
            # superc builds lanc_build_gf_superc_Gmix(iorb,jorb) for all
            # iorb /= jorb, ED_GF_SUPERC.f90)
            for a in range(norb):
                for b in range(norb):
                    if a == b:
                        continue
                    jp = table.cdg_sector(st.sector, up)
                    jm = table.c_sector(st.sector, up)
                    channel(("gaux", a, b), jp,
                            [("cdg", a, up), ("cdg", b, up)], [1, 1], 1.0, +1)
                    channel(("gaux", a, b), jm,
                            [("c", a, up), ("c", b, up)], [1, 1], 1.0, -1)
                    channel(("gaux", a, b), jp,
                            [("cdg", a, up), ("cdg", b, up)], [1, 1j], -1j, +1)
                    channel(("gaux", a, b), jm,
                            [("c", a, up), ("c", b, up)], [1, -1j], -1j, -1)
        # anomalous channels F_ab
        pairs = ([(a, a) for a in range(norb)] if cfg.bath_type == "normal"
                 else [(a, b) for a in range(norb) for b in range(norb)])
        for (a, b) in pairs:
            jp = table.cdg_sector(st.sector, up)   # sz+1 (c†↑ or c↓)
            jm = table.c_sector(st.sector, up)     # sz-1
            channel(("faux", a, b), jp,
                    [("cdg", a, up), ("c", b, dw)], [1, 1], 1.0, +1)
            channel(("faux", a, b), jm,
                    [("c", a, up), ("cdg", b, dw)], [1, 1], 1.0, -1)
            channel(("faux", a, b), jp,
                    [("cdg", a, up), ("c", b, dw)], [1, 1j], -1j, +1)
            channel(("faux", a, b), jm,
                    [("c", a, up), ("cdg", b, dw)], [1, -1j], -1j, -1)
    _phonon_gf_channels(cfg, table, sl, H, gf)
    H.flush()
    return gf


def eval_gf_superc(cfg: EDConfig, gf: GFMatrix, z):
    """Returns (G, F, barG): G,F (Nspin,Nspin,Norb,Norb,Lz); barG (Norb,Lz)."""
    z = np.atleast_1d(np.asarray(z, complex))
    norb = cfg.norb
    g = np.zeros((1, 1, norb, norb, len(z)), complex)
    f = np.zeros_like(g)
    barg = np.zeros((norb, len(z)), complex)
    for a in range(norb):
        g[0, 0, a, a] = gf.eval(("g", a, a), z)
        barg[a] = gf.eval(("barg", a), z)
    for a in range(norb):
        for b in range(norb):
            if a != b and ("gaux", a, b) in gf.channels:
                aux = gf.eval(("gaux", a, b), z)
                g[0, 0, a, b] = 0.5 * (aux - (1 - 1j)
                                       * (g[0, 0, a, a] + g[0, 0, b, b]))
            if ("faux", a, b) in gf.channels:
                aux = gf.eval(("faux", a, b), z)
                f[0, 0, a, b] = 0.5 * (aux - (1 - 1j) * (g[0, 0, a, a] + barg[b]))
    return g, f, barg


def sigma_superc(cfg: EDConfig, g, f, invg0, invf0, axis="m", f21=None):
    """Nambu Dyson (reference get_Sigma_superc, ED_GF_SUPERC.f90:938-1020):
    returns (Sigma, Self).

    ``f21``: the lower-left anomalous function F21 = F(z*) (the reference's
    get_impF_superc(zconj=.true.)); the Nambu 21 block is conj(F21)^T.
    Using conj(F12) instead is wrong by 2i Im F on the Matsubara axis — a
    phi^2-scale systematic in Sigma.  Falls back to conj(f) when absent."""
    norb = cfg.norb
    lz = g.shape[-1]
    sigma = np.zeros_like(g)
    self_ = np.zeros_like(g)
    for i in range(lz):
        gm = g[0, 0, :, :, i]
        fm = f[0, 0, :, :, i]
        if axis == "m":
            g22 = -np.conj(gm)
        else:
            g22 = -np.conj(g[0, 0, :, :, lz - 1 - i])
        m21 = np.conj(f21[0, 0, :, :, i]).T if f21 is not None \
            else np.conj(fm.T)
        m = np.block([[gm, fm], [m21, g22]])
        mi = np.linalg.inv(m)
        sigma[0, 0, :, :, i] = invg0[0, 0, :, :, i] - mi[:norb, :norb]
        self_[0, 0, :, :, i] = invf0[0, 0, :, :, i] - mi[:norb, norb:]
    return sigma, self_


def build_gf_nonsu2(cfg: EDConfig, table: SectorTable, sl: StateList,
                    matvec_builder, dense_eig_cache) -> GFMatrix:
    gf = GFMatrix()
    w = sl.boltzmann_weights()
    norb, nspin = cfg.norb, cfg.nspin
    ns = table.dims.ns
    H = _GfHarvester(cfg, table, matvec_builder, dense_eig_cache)
    keys = [(s, a) for s in range(nspin) for a in range(norb)]
    offdiag = cfg.ed_all_g or cfg.bath_type != "normal" \
        or cfg.ed_solve_offdiag_gf
    jz = cfg.jz_basis

    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v2 = st.vector.reshape(sec.dim_ph, sec.dim_el)
        ei = st.energy
        isec = st.sector

        def tgt(kind, a, s):
            """Target sector of c/c† (reference getC(DG)sector vs the Jz
            variants getC(DG)sector_Jz, ED_SETUP.f90:944-983)."""
            fn = table.cdg_sector if kind == "cdg" else table.c_sector
            return fn(isec, s, iorb=a) if jz else fn(isec, s)

        def channel(key, jsec, maps, coeffs, prefactor, sgn):
            if jsec is None or table.get_dim(jsec) == 0:
                return
            tsec = table.sector(jsec)
            ms = [joint_op(sec.states, tsec.states, ns, kind, lvl, spin)
                  for (kind, lvl, spin) in maps]
            phi = _lincomb_phi(v2, ms, coeffs)
            H.add_channel(gf, key, jsec, phi, w[ist] * prefactor, sgn, ei)

        for (s, a) in keys:
            channel(("g", (s, a), (s, a)), tgt("cdg", a, s),
                    [("cdg", a, s)], [1.0], 1.0, +1)
            channel(("g", (s, a), (s, a)), tgt("c", a, s),
                    [("c", a, s)], [1.0], 1.0, -1)
        if offdiag:
            for i1 in range(len(keys)):
                for i2 in range(i1 + 1, len(keys)):
                    (s1, a) = keys[i1]
                    (s2, b) = keys[i2]
                    jp, jm = tgt("cdg", a, s1), tgt("c", a, s1)
                    if jz and (jp != tgt("cdg", b, s2) or
                               jm != tgt("c", b, s2)):
                        # the mixed combo is only defined when both
                        # excitations land in the same (N,2Jz) sector
                        # (reference ED_GF_NONSU2.f90:231-290 dim guard)
                        continue
                    channel(("gaux", keys[i1], keys[i2]), jp,
                            [("cdg", a, s1), ("cdg", b, s2)], [1, 1], 1.0, +1)
                    channel(("gaux", keys[i1], keys[i2]), jm,
                            [("c", a, s1), ("c", b, s2)], [1, 1], 1.0, -1)
                    channel(("gaux", keys[i1], keys[i2]), jp,
                            [("cdg", a, s1), ("cdg", b, s2)], [1, 1j], -1j, +1)
                    channel(("gaux", keys[i1], keys[i2]), jm,
                            [("c", a, s1), ("c", b, s2)], [1, -1j], -1j, -1)
    _phonon_gf_channels(cfg, table, sl, H, gf)
    H.flush()
    return gf


def eval_gf_nonsu2(cfg: EDConfig, gf: GFMatrix, z):
    z = np.atleast_1d(np.asarray(z, complex))
    norb, nspin = cfg.norb, cfg.nspin
    g = np.zeros((nspin, nspin, norb, norb, len(z)), complex)
    keys = [(s, a) for s in range(nspin) for a in range(norb)]
    for (s, a) in keys:
        g[s, s, a, a] = gf.eval(("g", (s, a), (s, a)), z)
    for i1 in range(len(keys)):
        for i2 in range(i1 + 1, len(keys)):
            key = ("gaux", keys[i1], keys[i2])
            if key not in gf.channels:
                continue
            (s1, a) = keys[i1]
            (s2, b) = keys[i2]
            gdd = g[s1, s1, a, a] + g[s2, s2, b, b]
            aux = gf.eval(key, z)
            g[s1, s2, a, b] = 0.5 * (aux - (1 - 1j) * gdd)
            # Transpose element WITHOUT extra Lanczos channels: both aux
            # sub-correlators <<O;O†>> (O = c_i + c_j) and <<Q;Q†>>
            # (Q = c_i - i c_j) have real Lehmann weights, so
            # conj(aux(z*)) = A(z) + i B'(z) = (1+i)(G_ii+G_jj) + 2 G_ji —
            # the exact resolvent identity G_ji(z) = conj(G_ij(z*)).
            # Mirroring G_ji := G_ij instead is only valid for real H and
            # corrupts complex spin-mixing (SOC) cases
            # (tests/test_nonsu2_dyson_oracle.py).
            auxc = np.conj(gf.eval(key, np.conj(z)))
            g[s2, s1, b, a] = 0.5 * (auxc - (1 + 1j) * gdd)
    return g


def compute_observables_joint(cfg: EDConfig, table: SectorTable, sl: StateList,
                              hloc, um: Umatrix,
                              op_cache: Dict[int, JointSectorOp],
                              hloc_anomalous=None) -> Observables:
    norb = cfg.norb
    ns = table.dims.ns
    isdw = cfg.nspin - 1
    w = sl.boltzmann_weights()
    obs = Observables(
        dens=np.zeros(norb), dens_up=np.zeros(norb), dens_dw=np.zeros(norb),
        docc=np.zeros(norb), mag=np.zeros((3, norb)),
        sz2=np.zeros((norb, norb)), n2=np.zeros((norb, norb)),
        sp_dm=np.zeros((cfg.nspin, ns, ns), dtype=complex),
        ph_n=np.zeros(cfg.nph + 1), prob=np.zeros(3 ** norb))
    obs.egs = sl.e0
    if cfg.nph > 0:
        obs.ph_dm = np.zeros((cfg.nph + 1, cfg.nph + 1))
        # X = b + b† on the oscillator register (same convention as the
        # normal-mode observables, solver/observables.py)
        _xsq = np.sqrt(np.arange(1, cfg.nph + 1))
        _xmat = np.zeros((cfg.nph + 1,) * 2)
        _xmat[np.arange(1, cfg.nph + 1), np.arange(cfg.nph)] = _xsq
        _xmat[np.arange(cfg.nph), np.arange(1, cfg.nph + 1)] = _xsq
        _xmat2 = _xmat @ _xmat
    obs.phisc = np.zeros((norb, norb))
    obs.argphi = np.zeros((norb, norb))
    phi_c = np.zeros((norb, norb), complex)
    ust_nd = um.ust - np.diag(np.diag(um.ust))
    ustp_nd = um.ustp - np.diag(np.diag(um.ustp))

    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v2 = st.vector.reshape(sec.dim_ph, sec.dim_el).cpu().numpy()
        p2 = np.abs(v2) ** 2
        pe = p2.sum(axis=0)
        occ = occupations(sec.states, 2 * ns).astype(float)
        o_up = occ[:, :norb]
        o_dw = occ[:, ns: ns + norb]
        nu = pe @ o_up
        nd = pe @ o_dw
        obs.dens_up += w[ist] * nu
        obs.dens_dw += w[ist] * nd
        obs.dens += w[ist] * (nu + nd)
        obs.mag[2] += w[ist] * (nu - nd)
        q_ud = np.einsum("i,ia,ib->ab", pe, o_up, o_dw)
        q_uu = np.einsum("i,ia,ib->ab", pe, o_up, o_up)
        q_dd = np.einsum("i,ia,ib->ab", pe, o_dw, o_dw)
        obs.docc += w[ist] * np.diag(q_ud)
        obs.n2 += w[ist] * (q_uu + q_dd + q_ud + q_ud.T)
        sz2 = 0.25 * (q_uu + q_dd - q_ud - q_ud.T)
        obs.sz2 += w[ist] * sz2
        obs.s2tot += w[ist] * sz2.sum()
        # 3^Norb configuration probabilities (reference
        # ED_OBSERVABLES_SUPERC.f90:92,153: class index Σ_a (n_a↑+n_a↓) 3^a)
        pows = 3 ** np.arange(norb)
        cls = (o_up.astype(np.int64) + o_dw.astype(np.int64)) @ pows
        np.add.at(obs.prob, cls, w[ist] * pe)
        if cfg.nph > 0:
            pph = p2.sum(axis=1)
            obs.ph_n += w[ist] * pph
            # <X>, <X²>, phonon density matrix and energies (reference
            # ED_OBSERVABLES_SUPERC.f90:111,179,462 X_ph/X2_ph and
            # :809-830 Eph/Eeph; conventions match solver/observables.py)
            obs.ph_x += w[ist] * np.einsum("pe,pq,qe->", np.conj(v2),
                                           _xmat, v2).real
            obs.ph_x2 += w[ist] * np.einsum("pe,pq,qe->", np.conj(v2),
                                            _xmat2, v2).real
            obs.ph_dm += w[ist] * np.einsum("pe,qe->pq", np.conj(v2),
                                            v2).real
            obs.eph += w[ist] * cfg.w0_ph * float(
                np.arange(cfg.nph + 1) @ pph)
            op = op_cache.get(st.sector)
            if op is not None and getattr(op, "eph_diag", None) is not None:
                t = np.einsum("pe,pq,e,qe->", np.conj(v2), _xmat,
                              op.eph_diag, v2).real
                if getattr(op, "eph_rows", None) is not None \
                        and len(op.eph_rows):
                    a_ = np.conj(v2[:, op.eph_rows])
                    b_ = v2[:, op.eph_cols] * op.eph_vals[None, :]
                    t += np.real(np.einsum("pk,qk,pq->", a_, b_, _xmat))
                obs.eeph += w[ist] * t
            else:
                # twin-reconstructed sector (no cached op): default
                # orbital-diagonal coupling Σ_a g_aa (n_a↑+n_a↓) ⊗ X
                from ..models.normal import g_ph_matrix
                gd = np.diag(g_ph_matrix(cfg))
                eel = (o_up + o_dw) @ gd
                obs.eeph += w[ist] * np.einsum(
                    "pe,pq,e,qe->", np.conj(v2), _xmat, eel, v2).real
        # energies: eknot (imp one-body diag only here; offdiag via ops below)
        himp_u = np.real(np.asarray(hloc)[0, 0])
        himp_d = np.real(np.asarray(hloc)[isdw, isdw])
        obs.eknot += w[ist] * float(np.diag(himp_u) @ nu + np.diag(himp_d) @ nd)
        epot = float(um.uloc @ np.diag(q_ud))
        dust = dund = 0.0
        for a in range(norb):
            for b in range(a + 1, norb):
                du_ab = q_ud[a, b] + q_ud[b, a]
                epot += um.ust[a, b] * du_ab
                dust += du_ab
                dn_ab = q_uu[a, b] + q_dd[a, b]
                epot += um.ustp[a, b] * dn_ab
                dund += dn_ab
        obs.dust += w[ist] * dust
        obs.dund += w[ist] * dund

        def _expect(opstrings):
            """Sum_k coeff_k <v| O_k |v> on the electronic block (phonon-
            diagonal), O_k given as JointTermAccumulator opstrings."""
            acc = JointTermAccumulator(sec.states, ns)
            for opstr, coeff in opstrings:
                acc.add_opstring(list(opstr), coeff)
            rows, cols, vals = acc.coo()
            if len(rows) == 0:
                return 0.0 + 0j
            tot = 0.0 + 0j
            for p in range(sec.dim_ph):
                tot += np.sum(np.conj(v2[p, rows]) * vals * v2[p, cols])
            return tot

        # Jx spin-exchange / Jp pair-hopping expectations (reference
        # ED_OBSERVABLES_SUPERC.f90:626-661 / ED_OBSERVABLES_NONSU2.f90):
        # epot += Jx<X_ab> + Jp<P_ab>, Dse += <X_ab>, Dph += <P_ab>,
        # with the same operator ordering as the H builder (_jxjp_terms)
        for a in range(norb):
            for b in range(norb):
                if a == b:
                    continue
                if um.jx[a, b] != 0:
                    ex = np.real(_expect([
                        ((("c", b, SPIN_UP), ("c", a, SPIN_DW),
                          ("cdg", b, SPIN_DW), ("cdg", a, SPIN_UP)), 1.0)]))
                    epot += um.jx[a, b] * ex
                    obs.dse += w[ist] * ex
                if um.jp[a, b] != 0:
                    ep = np.real(_expect([
                        ((("c", b, SPIN_UP), ("c", b, SPIN_DW),
                          ("cdg", a, SPIN_DW), ("cdg", a, SPIN_UP)), 1.0)]))
                    epot += um.jp[a, b] * ep
                    obs.dph += w[ist] * ep
        # sundry U_ijkl two-body terms (nonsu2 only; superc rejects them at
        # build time) + mean-field one-body from the normal ordering
        if um.sundry:
            epot += np.real(_expect([(t.ops, t.coeff) for t in um.sundry]))
        mfu, mfd = np.real(um.mf_hloc[0, 0]), np.real(um.mf_hloc[1, 1])
        if np.any(mfu != 0) or np.any(mfd != 0):
            epot += float(np.diag(mfu) @ nu + np.diag(mfd) @ nd)
            hops = []
            for a in range(norb):
                for b in range(norb):
                    if a != b and mfu[a, b] != 0:
                        hops.append(((("c", b, SPIN_UP), ("cdg", a, SPIN_UP)),
                                     mfu[a, b]))
                    if a != b and mfd[a, b] != 0:
                        hops.append(((("c", b, SPIN_DW), ("cdg", a, SPIN_DW)),
                                     mfd[a, b]))
            if hops:
                epot += np.real(_expect(hops))
        # off-diagonal Hloc contribution to eknot (reference ED_OBSERVABLES
        # eknot off-diag terms; includes nonsu2 spin-mixing blocks)
        hl = np.asarray(hloc, complex)
        hops = []
        for s1 in range(cfg.nspin):
            for s2 in range(cfg.nspin):
                blk = hl[s1, s2]
                for a in range(norb):
                    for b in range(norb):
                        if (s1, a) != (s2, b) and blk[a, b] != 0:
                            hops.append(((("c", b, s2), ("cdg", a, s1)),
                                         blk[a, b]))
        if hops:
            obs.eknot += w[ist] * np.real(_expect(hops))
        # anomalous-Hloc eknot (reference ED_OBSERVABLES_SUPERC.f90:595-627:
        # ⟨Σ_ab ha_ab c†_a↑ c†_b↓ + h.c.⟩, pair_field excluded) — same
        # operator convention as the H builder (models/joint.py:283-298)
        if cfg.ed_mode == "superc" and hloc_anomalous is not None:
            han = np.asarray(hloc_anomalous, complex)
            ahops = []
            for a in range(norb):
                for b in range(norb):
                    if han[a, b] != 0:
                        ahops.append(((("cdg", b, SPIN_DW),
                                       ("cdg", a, SPIN_UP)), han[a, b]))
                        ahops.append(((("c", a, SPIN_UP), ("c", b, SPIN_DW)),
                                      np.conj(han[a, b])))
            if ahops:
                obs.eknot += w[ist] * np.real(_expect(ahops))
        obs.eint += w[ist] * epot
        if cfg.hfmode:
            ntot = nu + nd
            eh = float(-0.5 * um.uloc @ ntot + 0.25 * um.uloc.sum())
            for a in range(norb):
                for b in range(a + 1, norb):
                    eh += -0.5 * (um.ust[a, b] + um.ustp[a, b]) * (ntot[a] + ntot[b]) \
                        + 0.5 * (um.ust[a, b] + um.ustp[a, b])
            obs.ehartree += w[ist] * eh
        # nonsu2 exciton order parameters from the spin-resolved impurity
        # density matrix D[s1 a, s2 b] = <c+_{a s1} c_{b s2}> (reference
        # ED_OBSERVABLES_NONSU2.f90:330-423 theta/omega construction:
        # S0 = 2Re(D_uu+D_dd), Tz = 2Re(D_uu-D_dd), Tx = 2Re(D_ud+D_du),
        # Ty = 2Im(D_du-D_ud))
        if cfg.ed_mode == "nonsu2":
            dmat = np.zeros((2, 2, norb, norb), complex)
            for s1 in range(2):
                for s2 in range(2):
                    for a in range(norb):
                        for b in range(norb):
                            dmat[s1, s2, a, b] = _expect(
                                [((("c", b, s2), ("cdg", a, s1)), 1.0)])
            # spin-resolved impurity sp density matrix ⟨c†_{a s1} c_{b s2}⟩
            # — feeds the quantum-SOC-operator getter (reference
            # get_imp_SOC_op.f90:289-400 via single_particle_density_matrix)
            if obs.imp_dm_nn is None:
                obs.imp_dm_nn = np.zeros((2, 2, norb, norb), complex)
            obs.imp_dm_nn += w[ist] * dmat
        if cfg.ed_mode == "nonsu2" and norb > 1:
            if obs.exct is None:
                obs.exct = np.zeros((4, norb, norb))
            for a in range(norb):
                for b in range(norb):
                    duu, ddd = dmat[0, 0, a, b], dmat[1, 1, a, b]
                    dud, ddu = dmat[0, 1, a, b], dmat[1, 0, a, b]
                    obs.exct[0, a, b] += w[ist] * 2 * np.real(duu + ddd)
                    obs.exct[1, a, b] += w[ist] * 2 * np.real(dud + ddu)
                    obs.exct[2, a, b] += w[ist] * 2 * np.imag(ddu - dud)
                    obs.exct[3, a, b] += w[ist] * 2 * np.real(duu - ddd)
        # nonsu2 in-plane magnetization: 2<Sx_a>, 2<Sy_a>
        if cfg.ed_mode == "nonsu2":
            for a in range(norb):
                acc = JointTermAccumulator(sec.states, ns)
                acc.add_opstring([("c", a, SPIN_DW), ("cdg", a, SPIN_UP)], 1.0)
                rows, cols, vals = acc.coo()
                sud = 0.0 + 0j
                for p in range(sec.dim_ph):
                    sud += np.sum(np.conj(v2[p, rows]) * vals * v2[p, cols])
                obs.mag[0, a] += w[ist] * 2.0 * np.real(sud)
                obs.mag[1, a] += w[ist] * (-2.0) * np.imag(sud)
        # superc order parameter phi_ab = <c_{b,up} c_{a,dw}>
        if cfg.ed_mode == "superc":
            for a in range(norb):
                for b in range(norb):
                    phi_c[a, b] += w[ist] * _expect(
                        [((("c", a, SPIN_DW), ("c", b, SPIN_UP)), 1.0)])
    obs.epot = obs.eint + obs.ehartree
    if cfg.ed_mode == "superc":
        obs.phisc = np.abs(phi_c)
        obs.argphi = np.arctan2(np.imag(phi_c), np.real(phi_c))
    return obs


def joint_builders(cfg: EDConfig, table: SectorTable, hloc, um: Umatrix,
                   bath: DmftBath, device: torch.device, hloc_anomalous=None,
                   mesh=None):
    """Operator / matvec builders of a joint-mode solve (cached per
    sector); see the module docstring for the routing."""
    op_cache: Dict[int, JointSectorOp] = {}
    mv_cache: Dict[int, object] = {}
    dense_cache: Dict[int, Tuple] = {}
    use_kron = cfg.ed_joint_kron == "always"

    def get_op(sec: Sector) -> JointSectorOp:
        if sec.index not in op_cache:
            op_cache[sec.index] = build_joint_sector_op(
                cfg, sec, hloc, um, bath, hloc_anomalous=hloc_anomalous)
        return op_cache[sec.index]

    def matvec_builder(sec: Sector):
        if sec.index not in mv_cache:
            split = mesh is not None and shard_joint(sec.dim,
                                                     cfg.lanc_dim_threshold)
            if use_kron and sec.qn[0] in ("sz", "nt"):
                from ..models.joint_kron import build_joint_kron_op
                mv = build_joint_kron_op(cfg, sec, hloc, um, bath, device,
                                         hloc_anomalous=hloc_anomalous,
                                         mesh=mesh if split else None)
            elif not cfg.ed_sparse_h:
                mv = JointMatvecDirect(get_op(sec), device)
            elif split:
                mv = ShardedJointMatvec(get_op(sec), device, mesh)
            else:
                mv = JointMatvec(get_op(sec), device)
            if cfg.ed_verbose >= 4:
                nblk = len(getattr(mv, "blocks", []) or [])
                print(f"[edipack_tpu_torch:DEBUG] joint sector {sec.index} "
                      f"qn={sec.qn} dim={sec.dim} -> {type(mv).__name__}"
                      + (f" blocks={nblk}" if nblk else "")
                      + (" sharded" if getattr(mv, "mesh", None) is not None
                         else ""))
            mv_cache[sec.index] = mv
        return mv_cache[sec.index]

    def dense_builder(sec: Sector) -> np.ndarray:
        return get_op(sec).to_dense()

    def dense_eig_cache(isec: int):
        """Full eigh of small sectors, cached, for exact GF moments."""
        sec = table.sector(isec)
        if sec.dim > cfg.lanc_dim_threshold:
            return None
        if isec not in dense_cache:
            evals, evecs = np.linalg.eigh(dense_builder(sec))
            dense_cache[isec] = (evals, torch.as_tensor(evecs, device=device))
        return dense_cache[isec]

    from types import SimpleNamespace
    return SimpleNamespace(matvec_builder=matvec_builder,
                           dense_builder=dense_builder,
                           dense_eig_cache=dense_eig_cache,
                           op_cache=op_cache, mv_cache=mv_cache)


def solve_impurity_joint(cfg: EDConfig, hloc, um: Umatrix, bath: DmftBath,
                         device: torch.device, neigen_override=None,
                         sector_mask=None, hloc_anomalous=None,
                         flag_gf: bool = True):
    from .core import SolveResult, _solve_mesh
    table = SectorTable(cfg)
    mesh = _solve_mesh(cfg, device)
    b = joint_builders(cfg, table, hloc, um, bath, device, hloc_anomalous,
                       mesh)
    timer = PhaseTimer(device, verbose=cfg.ed_verbose)
    with timer.phase("diagonalization"):
        diag = diagonalize(cfg, table, b.matvec_builder, b.dense_builder,
                           device, neigen_override=neigen_override,
                           sector_mask=sector_mask, mesh=mesh)
    gf = GFMatrix()
    if flag_gf:
        with timer.phase("greens_functions"):
            build = build_gf_superc if cfg.ed_mode == "superc" \
                else build_gf_nonsu2
            gf = build(cfg, table, diag.state_list, b.matvec_builder,
                       b.dense_eig_cache)
    with timer.phase("observables"):
        obs = compute_observables_joint(cfg, table, diag.state_list, hloc,
                                        um, b.op_cache,
                                        hloc_anomalous=hloc_anomalous)
    rdm = None
    if cfg.rdm_flag:
        from .rdm import impurity_rdm_joint
        with timer.phase("impurity_rdm"):
            rdm = impurity_rdm_joint(cfg, table, diag.state_list)
    return SolveResult(cfg=cfg, table=table, diag=diag, gf=gf, obs=obs,
                       bath=bath.copy(), hloc=np.asarray(hloc), um=um,
                       device=device, timings=dict(timer.timings),
                       n_matvecs=sum(mv.n_calls
                                     for mv in b.mv_cache.values()),
                       rdm=rdm, hloc_anomalous=hloc_anomalous)
