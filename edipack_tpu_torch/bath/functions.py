"""Analytic bath functions on arbitrary complex-frequency grids.

Parity target: reference ED_BATH/ED_BATH_FUNCTIONS.f90 + the
delta_functions/g0and_functions/invg0_functions include trees (:124-132):
hybridization Δ(z), anomalous FΔ(z), Weiss field G0and(z) and its inverse for
every (bath_type × ed_mode). All functions are vectorized over the z grid
(NumPy; small arrays — post-processing, not the solve hot path).

Shapes: z (Lz,) complex; outputs (Nspin, Nspin, Norb, Norb, Lz) matching the
reference's rank-5 arrays. For superc the anomalous parts are returned by the
``f``-variants (Nambu off-diagonal blocks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import EDConfig
from .dmft_bath import DmftBath


def _zgrid(z) -> np.ndarray:
    return np.atleast_1d(np.asarray(z, dtype=complex))


def delta_bath(cfg: EDConfig, bath: DmftBath, z) -> np.ndarray:
    """Δ(z): (Nspin,Nspin,Norb,Norb,Lz). Spin-diagonal except nonsu2 with
    spin-flip u amplitudes."""
    z = _zgrid(z)
    ns, no, nb, lz = cfg.nspin, cfg.norb, cfg.nbath, len(z)
    out = np.zeros((ns, ns, no, no, lz), dtype=complex)
    if cfg.nbath == 0:
        return out
    if cfg.bath_type == "normal":
        if cfg.ed_mode == "normal":
            # Δ_aa^s = Σ_k v²/(z - e)
            for s in range(ns):
                for a in range(no):
                    out[s, s, a, a] = np.sum(
                        bath.v[s, a, :, None] ** 2
                        / (z[None, :] - bath.e[s, a, :, None]), axis=0)
        elif cfg.ed_mode == "superc":
            # Nambu-diagonal: Δ_aa = Σ_k v² (z+e)/(z² - (e²+d²))
            for a in range(no):
                e, d, v = bath.e[0, a], bath.d[0, a], bath.v[0, a]
                den = z[None, :] ** 2 - (e[:, None] ** 2 + d[:, None] ** 2)
                out[0, 0, a, a] = np.sum(v[:, None] ** 2 * (z[None, :] + e[:, None])
                                         / den, axis=0)
        else:  # nonsu2: spin-flip u mixes spins
            for a in range(no):
                for s1 in range(ns):
                    for s2 in range(ns):
                        w1 = np.stack([bath.v[s1, a], bath.u[s1, a]])
                        w2 = np.stack([bath.v[s2, a], bath.u[s2, a]])
                        # coupling of spin s to bath spin sigma: v if sigma==s else u
                        # Δ^{s1 s2} = Σ_k Σ_sigma w1[sigma] w2[sigma] /(z - e)
                        # with w[sigma] = v if sigma == s else u
                        g1 = np.where(np.arange(2)[:, None] == s1,
                                      bath.v[s1, a][None, :], bath.u[s1, a][None, :])
                        g2 = np.where(np.arange(2)[:, None] == s2,
                                      bath.v[s2, a][None, :], bath.u[s2, a][None, :])
                        esig = bath.e[np.minimum(np.arange(2), ns - 1), a]  # (2, nb)
                        out[s1, s2, a, a] = np.sum(
                            (g1 * g2)[:, :, None] / (z[None, None, :]
                                                     - esig[:, :, None]),
                            axis=(0, 1))
        return out
    if cfg.bath_type == "hybrid":
        if cfg.ed_mode == "normal":
            for s in range(ns):
                for a in range(no):
                    for b in range(no):
                        out[s, s, a, b] = np.sum(
                            (bath.v[s, a, :] * bath.v[s, b, :])[:, None]
                            / (z[None, :] - bath.e[s, 0, :, None]), axis=0)
        elif cfg.ed_mode == "superc":
            e, d = bath.e[0, 0], bath.d[0, 0]
            den = z[None, :] ** 2 - (e[:, None] ** 2 + d[:, None] ** 2)
            for a in range(no):
                for b in range(no):
                    vv = (bath.v[0, a] * bath.v[0, b])[:, None]
                    out[0, 0, a, b] = np.sum(vv * (z[None, :] + e[:, None]) / den,
                                             axis=0)
        else:
            for a in range(no):
                for b in range(no):
                    for s1 in range(ns):
                        for s2 in range(ns):
                            g1 = np.where(np.arange(2)[:, None] == s1,
                                          bath.v[s1, a][None, :],
                                          bath.u[s1, a][None, :])
                            g2 = np.where(np.arange(2)[:, None] == s2,
                                          bath.v[s2, b][None, :],
                                          bath.u[s2, b][None, :])
                            esig = bath.e[np.minimum(np.arange(2), ns - 1), 0]
                            out[s1, s2, a, b] = np.sum(
                                (g1 * g2)[:, :, None]
                                / (z[None, None, :] - esig[:, :, None]),
                                axis=(0, 1))
        return out
    # replica / general: Δ(z) = Σ_k V_k (z - H_k)^{-1} V_k^T in (Nspin*Norb)
    nso = ns * no
    hb = bath.hbath()  # (Nbath, Nspin, Nspin, Norb, Norb)
    if cfg.ed_mode == "superc":
        return _delta_replica_superc(cfg, bath, z)
    for k in range(nb):
        hk = hb[k].transpose(0, 2, 1, 3).reshape(nso, nso)
        vk = np.diag(bath.hyb(k))
        for iz, zz in enumerate(z):
            g = np.linalg.inv(zz * np.eye(nso) - hk)
            d = vk @ g @ vk
            out[..., iz] += d.reshape(ns, no, ns, no).transpose(0, 2, 1, 3)
    return out


def fdelta_bath(cfg: EDConfig, bath: DmftBath, z) -> np.ndarray:
    """Anomalous FΔ(z) (superc only): (Nspin,Nspin,Norb,Norb,Lz)."""
    z = _zgrid(z)
    ns, no, nb, lz = cfg.nspin, cfg.norb, cfg.nbath, len(z)
    out = np.zeros((ns, ns, no, no, lz), dtype=complex)
    if cfg.ed_mode != "superc" or nb == 0:
        return out
    if cfg.bath_type == "normal":
        for a in range(no):
            e, d, v = bath.e[0, a], bath.d[0, a], bath.v[0, a]
            den = z[None, :] ** 2 - (e[:, None] ** 2 + d[:, None] ** 2)
            out[0, 0, a, a] = np.sum(-v[:, None] ** 2 * d[:, None] / den, axis=0)
    elif cfg.bath_type == "hybrid":
        e, d = bath.e[0, 0], bath.d[0, 0]
        den = z[None, :] ** 2 - (e[:, None] ** 2 + d[:, None] ** 2)
        for a in range(no):
            for b in range(no):
                vv = (bath.v[0, a] * bath.v[0, b])[:, None]
                out[0, 0, a, b] = np.sum(-vv * d[:, None] / den, axis=0)
    else:
        fd = _delta_replica_superc(cfg, bath, z, anomalous=True)
        return fd
    return out


def _delta_replica_superc(cfg: EDConfig, bath: DmftBath, z,
                          anomalous: bool = False) -> np.ndarray:
    """Replica superc: Nambu-resolved Δ via 2Norb×2Norb inversion per replica.
    H_k^Nambu = [[h_k, Δ_k],[Δ_k, -h_k^T]] with Δ_k from the d-like basis ops
    — the replica basis in superc mode is interpreted in Nambu space directly."""
    z = _zgrid(z)
    ns, no, nb, lz = cfg.nspin, cfg.norb, cfg.nbath, len(z)
    out = np.zeros((ns, ns, no, no, lz), dtype=complex)
    hb = bath.hbath()
    for k in range(nb):
        hk = hb[k, 0, 0]  # (Norb, Norb) normal block
        # anomalous block from the (0,1)-ish slot if the basis carries one
        dk = hb[k, 0, 1] if hb.shape[1] > 1 else np.zeros_like(hk)
        vk = np.diag(bath.hyb(k)[:no])
        hnam = np.block([[hk, dk], [dk.conj().T, -hk.T]])
        vnam = np.block([[vk, np.zeros_like(vk)], [np.zeros_like(vk), -vk]])
        for iz, zz in enumerate(z):
            g = np.linalg.inv(zz * np.eye(2 * no) - hnam)
            d = vnam @ g @ vnam
            if anomalous:
                out[0, 0, :, :, iz] += d[:no, no:]
            else:
                out[0, 0, :, :, iz] += d[:no, :no]
    return out


# ---------------------------------------------------------------------------


def invf0_bath(cfg: EDConfig, bath: DmftBath, hloc_anomalous, z) -> np.ndarray:
    """F0⁻¹(z) = −Hloc_anomalous − FΔ(z): the anomalous (1,2) Nambu block
    of G0(z)⁻¹ (reference invf0_normal.f90:23).

    Sign VERIFIED against a pure-Lehmann oracle
    (tests/test_superc_dyson_oracle.py): assembling the U=0 quadratic
    Hamiltonian's Nambu resolvent in the Ψ=(c↑, c†↓) basis and inverting
    gives exactly −ha − FΔ in this engine's F = ⟪c↑; c↓⟫ / fdelta_bath
    conventions — so Self = F0⁻¹ − (G⁻¹)₁₂ is the exact Nambu-Dyson
    anomalous self-energy, vanishing identically at U=0."""
    z = _zgrid(z)
    fd = fdelta_bath(cfg, bath, z)
    out = -fd
    if hloc_anomalous is not None:
        han = np.asarray(hloc_anomalous, complex)
        out = out - han[None, None][..., None] if han.ndim == 2 \
            else out - han[..., None]
    return out


def invg0_bath(cfg: EDConfig, bath: DmftBath, hloc: np.ndarray, z) -> np.ndarray:
    """G0⁻¹(z)_ab^{ss'} = (z + μ)δ - Hloc - Δ(z) (normal part)."""
    z = _zgrid(z)
    ns, no, lz = cfg.nspin, cfg.norb, len(z)
    delta = delta_bath(cfg, bath, z)
    out = np.zeros_like(delta)
    eye = np.eye(no)
    for s1 in range(ns):
        for s2 in range(ns):
            blk = -np.asarray(hloc[s1, s2], complex)[:, :, None] - delta[s1, s2]
            if s1 == s2:
                blk = blk + (z[None, None, :] + cfg.xmu) * eye[:, :, None]
            out[s1, s2] = blk
    return out


def g0and_bath(cfg: EDConfig, bath: DmftBath, hloc: np.ndarray, z) -> np.ndarray:
    """G0and(z): inverse of invg0 as a (Nspin*Norb) matrix per frequency."""
    z = _zgrid(z)
    inv = invg0_bath(cfg, bath, hloc, z)
    return _block_inv(inv)


def _block_inv(m5: np.ndarray) -> np.ndarray:
    """Invert a (Nspin,Nspin,Norb,Norb,Lz) array as (Nspin*Norb)² per z."""
    ns, _, no, _, lz = m5.shape
    nso = ns * no
    m = m5.transpose(4, 0, 2, 1, 3).reshape(lz, nso, nso)
    mi = np.linalg.inv(m)
    return mi.reshape(lz, ns, no, ns, no).transpose(1, 3, 2, 4, 0)


def matsubara_grid(cfg: EDConfig, n: Optional[int] = None) -> np.ndarray:
    n = n or cfg.lmats
    wn = (2 * np.arange(n) + 1) * np.pi / cfg.beta
    return 1j * wn


def real_grid(cfg: EDConfig, n: Optional[int] = None) -> np.ndarray:
    n = n or cfg.lreal
    w = np.linspace(cfg.wini, cfg.wfin, n)
    return w + 1j * cfg.eps
