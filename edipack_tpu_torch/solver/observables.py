"""Static observables and local energy from the retained spectrum.

Parity target: reference ED_NORMAL/ED_OBSERVABLES_NORMAL (observables_normal
:78-482, local_energy_normal :491-949); counterpart of
edipack_tpu.solver.observables.compute_observables_normal. The contractions
over each state vector (|ψ|² marginals, one-body hop expectations, the
non-local Jx/Jp factors) run on the device; the small per-orbital
bookkeeping runs in NumPy.

Energy bookkeeping (reference :505-949):
  eknot     = <impurity one-body Hloc> (no xmu, no fields)
  epot      = <Hint> + ehartree ; eint = <Hint> (no Hartree)
  ehartree  = Hartree shift terms (hfmode)
  doubles   = (dust, dund, dse, dph)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..config import EDConfig
from ..fock import hop_elements, occupations
from ..models.normal import NormalSectorOp
from ..sectors import SectorTable
from ..umatrix import Umatrix
from .eigenspace import StateList


@dataclass
class Observables:
    dens: np.ndarray = None       # (Norb,)
    dens_up: np.ndarray = None
    dens_dw: np.ndarray = None
    docc: np.ndarray = None       # (Norb,)
    mag: np.ndarray = None        # (3, Norb) x,y,z
    sz2: np.ndarray = None        # (Norb, Norb) <Sz_i Sz_j>
    n2: np.ndarray = None         # (Norb, Norb) <n_i n_j>
    s2tot: float = 0.0
    egs: float = 0.0
    # energies
    eknot: float = 0.0
    epot: float = 0.0
    eint: float = 0.0
    ehartree: float = 0.0
    # doubles
    dust: float = 0.0
    dund: float = 0.0
    dse: float = 0.0
    dph: float = 0.0
    # single-particle density matrix (Nspin, Ns, Ns) over imp+bath levels
    sp_dm: np.ndarray = None
    # exciton order parameters (4, Norb, Norb): S0, Tx, Ty, Tz
    exct: np.ndarray = None
    # 3^Norb impurity configuration probabilities
    prob: np.ndarray = None
    # phonons
    ph_x: float = 0.0
    ph_x2: float = 0.0
    ph_n: np.ndarray = None       # occupation distribution (Nph+1,)
    ph_dm: np.ndarray = None      # phonon density matrix (Nph+1, Nph+1)
    eph: float = 0.0
    eeph: float = 0.0

    @property
    def energies(self) -> np.ndarray:
        """reference ed_get_eimp ordering: (epot, eint, ehartree, eknot)."""
        return np.array([self.epot, self.eint, self.ehartree, self.eknot])

    @property
    def doubles(self) -> np.ndarray:
        return np.array([self.dust, self.dund, self.dse, self.dph])

    @property
    def imp_info(self) -> np.ndarray:
        return np.array([self.s2tot, self.egs])


def phonon_position_pdf(cfg: EDConfig, obs: Observables):
    """Phonon displacement probability distribution P(x) on the [xmin,xmax]
    grid (reference lattice PDF, Lpos points): P(x) = Σ_nm ρ^ph_nm ψ_n ψ_m
    with harmonic-oscillator eigenfunctions in natural units."""
    x = np.linspace(cfg.xmin, cfg.xmax, cfg.lpos)
    nmax = cfg.nph
    # Hermite functions via stable recurrence: h_0 = π^{-1/4} e^{-x²/2},
    # h_{n+1} = sqrt(2/(n+1)) x h_n - sqrt(n/(n+1)) h_{n-1}
    h = np.zeros((nmax + 1, len(x)))
    h[0] = np.pi ** -0.25 * np.exp(-x ** 2 / 2)
    if nmax >= 1:
        h[1] = np.sqrt(2.0) * x * h[0]
    for n in range(1, nmax):
        h[n + 1] = np.sqrt(2.0 / (n + 1)) * x * h[n] \
            - np.sqrt(n / (n + 1.0)) * h[n - 1]
    pdf = np.einsum("nm,nx,mx->x", obs.ph_dm, h, h)
    return x, pdf


def _expect_axis_hop(v3: torch.Tensor, basis, ns: int, i: int, j: int,
                     axis: int) -> float:
    """<ψ| c†_i c_j |ψ> on one spin axis (same sector; i,j any levels)."""
    rows, cols, signs = hop_elements(np.asarray(basis), ns, i, j)
    if len(rows) == 0:
        return 0.0
    dev = v3.device
    r = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    c = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    s = torch.as_tensor(signs, dtype=v3.dtype, device=dev)
    dims = (0, 1) if axis == 2 else (0, 2)
    contrib = (v3.index_select(axis, r) * v3.index_select(axis, c)).sum(dims)
    return float(s @ contrib)


def _phonon_terms(cfg: EDConfig, obs: Observables, w: float, v3: np.ndarray,
                  p2: np.ndarray, op, norb: int, occ_u: np.ndarray,
                  occ_d: np.ndarray) -> None:
    pph = np.einsum("pdu->p", p2)
    obs.ph_n += w * pph
    nvec = np.arange(cfg.nph + 1)
    x = np.zeros((cfg.nph + 1,) * 2)
    sq = np.sqrt(np.arange(1, cfg.nph + 1))
    x[np.arange(1, cfg.nph + 1), np.arange(cfg.nph)] = sq
    x[np.arange(cfg.nph), np.arange(1, cfg.nph + 1)] = sq
    obs.ph_x += w * np.einsum("pdu,pq,qdu->", v3, x, v3)
    obs.ph_x2 += w * np.einsum("pdu,pq,qdu->", v3, x @ x, v3)
    obs.ph_dm += w * np.einsum("pdu,qdu->pq", v3, v3)
    obs.eph += w * cfg.w0_ph * float(nvec @ pph)
    if op is not None and op.eph_d is not None:
        t = np.einsum("pdu,pq,du,qdu->", v3, x, op.eph_d, v3)
        if op.eph_up is not None:
            t += np.einsum("pdu,pq,uv,qdv->", v3, x, op.eph_up, v3)
        if op.eph_dw is not None:
            t += np.einsum("pdu,pq,de,qeu->", v3, x, op.eph_dw, v3)
        obs.eeph += w * t
    else:
        # twin-reconstructed sector (no cached op): the default coupling
        # is orbital-diagonal, Σ_a g_aa (n_a↑+n_a↓) ⊗ X
        from ..models.normal import g_ph_matrix
        gd = np.diag(g_ph_matrix(cfg))
        eel = (occ_d[:, :norb] @ gd)[:, None] + (occ_u[:, :norb] @ gd)[None, :]
        obs.eeph += w * np.einsum("pdu,pq,du,qdu->", v3, x, eel, v3)


def compute_observables_normal(cfg: EDConfig, table: SectorTable,
                               sl: StateList, hloc: np.ndarray, um: Umatrix,
                               op_cache: Dict[int, NormalSectorOp],
                               with_sp_dm: bool = True) -> Observables:
    norb = cfg.norb
    ns = table.dims.ns
    isdw = cfg.nspin - 1
    w = sl.boltzmann_weights()
    obs = Observables(
        dens=np.zeros(norb), dens_up=np.zeros(norb), dens_dw=np.zeros(norb),
        docc=np.zeros(norb), mag=np.zeros((3, norb)),
        sz2=np.zeros((norb, norb)), n2=np.zeros((norb, norb)),
        sp_dm=np.zeros((cfg.nspin, ns, ns), dtype=complex) if with_sp_dm
        else None,
        prob=np.zeros(3 ** norb),
        ph_n=np.zeros(cfg.nph + 1),
        ph_dm=np.zeros((cfg.nph + 1, cfg.nph + 1)))
    obs.egs = sl.e0

    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        p2t = v3 * v3
        pj = p2t.sum(0).cpu().numpy()              # (dw, up)
        pu = pj.sum(0)
        pd = pj.sum(1)
        occ_u = occupations(sec.ups, ns).astype(float)
        occ_d = occupations(sec.dws, ns).astype(float)
        nu_lvl = pu @ occ_u            # (ns,) <n_up(level)>
        nd_lvl = pd @ occ_d
        nu = nu_lvl[:norb]
        nd = nd_lvl[:norb]
        obs.dens_up += w[ist] * nu
        obs.dens_dw += w[ist] * nd
        obs.dens += w[ist] * (nu + nd)
        obs.mag[2] += w[ist] * (nu - nd)
        # joint moments: q_ud[a,b] = <ndw_a nup_b>
        q_ud = np.einsum("du,da,ub->ab", pj, occ_d[:, :norb], occ_u[:, :norb])
        obs.docc += w[ist] * np.diag(q_ud)
        q_uu = np.einsum("u,ua,ub->ab", pu, occ_u[:, :norb], occ_u[:, :norb])
        q_dd = np.einsum("d,da,db->ab", pd, occ_d[:, :norb], occ_d[:, :norb])
        n2 = q_uu + q_dd + q_ud + q_ud.T
        obs.n2 += w[ist] * n2
        sz2 = 0.25 * (q_uu + q_dd - q_ud - q_ud.T)
        obs.sz2 += w[ist] * sz2
        obs.s2tot += w[ist] * float(sz2.sum())
        # 3^Norb configuration probabilities: class Σ_a (nup_a + ndw_a) 3^a
        pows = 3 ** np.arange(norb)
        cls = (occ_d[:, :norb].astype(np.int64) @ pows)[:, None] \
            + (occ_u[:, :norb].astype(np.int64) @ pows)[None, :]
        np.add.at(obs.prob, cls.ravel(), w[ist] * pj.ravel())
        op = op_cache.get(st.sector)
        if cfg.nph > 0:
            _phonon_terms(cfg, obs, w[ist], v3.cpu().numpy(),
                          p2t.cpu().numpy(), op, norb, occ_u, occ_d)
        # single-particle density matrix (imp+bath levels)
        if with_sp_dm:
            for i in range(ns):
                obs.sp_dm[0, i, i] += w[ist] * nu_lvl[i]
                if cfg.nspin > 1:
                    obs.sp_dm[isdw, i, i] += w[ist] * nd_lvl[i]
            for i in range(ns):
                for j in range(ns):
                    if i == j:
                        continue
                    obs.sp_dm[0, i, j] += w[ist] * _expect_axis_hop(
                        v3, sec.ups, ns, i, j, 2)
                    if cfg.nspin > 1:
                        obs.sp_dm[1, i, j] += w[ist] * _expect_axis_hop(
                            v3, sec.dws, ns, i, j, 1)

        # ---- energies -------------------------------------------------
        himp_u = np.real(hloc[0, 0])
        himp_d = np.real(hloc[isdw, isdw])
        obs.eknot += w[ist] * float(np.diag(himp_u) @ nu
                                    + np.diag(himp_d) @ nd)
        for a in range(norb):
            for b in range(norb):
                if a != b and himp_u[a, b] != 0:
                    obs.eknot += w[ist] * float(himp_u[a, b] * _expect_axis_hop(
                        v3, sec.ups, ns, a, b, 2))
                if a != b and himp_d[a, b] != 0:
                    obs.eknot += w[ist] * float(himp_d[a, b] * _expect_axis_hop(
                        v3, sec.dws, ns, a, b, 1))
        # interaction expectation values
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
        # Jx / Jp / sundry expectations via the signed-permutation factors
        if op is None:
            continue
        if op.nl_perm is not None:
            # (B⊗A v)[d,u] = sb[d] sa[u] v[src_b[d], src_a[u]]
            src_a, sgn_a, src_b, sgn_b = op.nl_perm
            dev, dt = v3.device, v3.dtype
            exp_k = np.zeros(src_a.shape[0])
            for kk in range(src_a.shape[0]):
                ib = torch.as_tensor(src_b[kk], dtype=torch.int64, device=dev)
                ia = torch.as_tensor(src_a[kk], dtype=torch.int64, device=dev)
                sb = torch.as_tensor(sgn_b[kk], dtype=dt, device=dev)
                sa = torch.as_tensor(sgn_a[kk], dtype=dt, device=dev)
                t = v3.index_select(1, ib).index_select(2, ia)
                t = t * (sb[None, :, None] * sa[None, None, :])
                exp_k[kk] = float((v3 * t).sum())
            epot += float(exp_k.sum())
            # split dse/dph accounting by the Kanamori factor count
            kx = int(np.count_nonzero(um.jx)) if norb > 1 else 0
            jx_flat = um.jx[um.jx != 0]
            jp_flat = um.jp[um.jp != 0]
            for kk, ev in enumerate(exp_k):
                if kk < kx:
                    obs.dse += w[ist] * ev / jx_flat[kk] \
                        if jx_flat[kk] != 0 else 0.0
                    continue
                kp_idx = kk - kx
                if kp_idx < len(jp_flat) and jp_flat[kp_idx] != 0:
                    obs.dph += w[ist] * ev / jp_flat[kp_idx]
        # mean-field one-body from sundry normal ordering
        mfu, mfd = np.real(um.mf_hloc[0, 0]), np.real(um.mf_hloc[1, 1])
        if np.any(mfu != 0) or np.any(mfd != 0):
            epot += float(np.diag(mfu) @ nu + np.diag(mfd) @ nd)
            for a in range(norb):
                for b in range(norb):
                    if a != b and mfu[a, b] != 0:
                        epot += float(mfu[a, b] * _expect_axis_hop(
                            v3, sec.ups, ns, a, b, 2))
                    if a != b and mfd[a, b] != 0:
                        epot += float(mfd[a, b] * _expect_axis_hop(
                            v3, sec.dws, ns, a, b, 1))
        obs.eint += w[ist] * epot
        # Hartree
        if cfg.hfmode:
            ntot = nu + nd
            eh = float(-0.5 * um.uloc @ ntot + 0.25 * um.uloc.sum())
            for a in range(norb):
                for b in range(a + 1, norb):
                    coeff = um.ust[a, b] + um.ustp[a, b]
                    eh += -0.5 * coeff * (ntot[a] + ntot[b]) \
                        + 0.5 * (um.ust[a, b] + um.ustp[a, b])
            obs.ehartree += w[ist] * eh

    obs.epot = obs.eint + obs.ehartree
    # exciton order parameters over the impurity block (S0 and Tz; Tx/Ty
    # need spin mixing and vanish identically in the normal mode)
    if with_sp_dm:
        dm_up = obs.sp_dm[0, :norb, :norb]
        dm_dw = obs.sp_dm[cfg.nspin - 1, :norb, :norb] if cfg.nspin > 1 \
            else dm_up
        obs.exct = np.zeros((4, norb, norb))
        obs.exct[0] = np.real(dm_up + dm_dw)      # S0
        obs.exct[3] = np.real(dm_up - dm_dw)      # Tz
    return obs
