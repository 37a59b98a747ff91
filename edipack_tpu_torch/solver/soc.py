"""Quantum SOC operator expectations for the nonsu2 t2g model
(counterpart of edipack_tpu.solver.soc; host NumPy, kept as this package's
own copy).

Parity target: reference ED_IO/get_imp_SOC_op.f90 (helper matrices
:145-290, ed_get_quantum_SOC_operators_single :289-400).  Everything is a
trace of the spin-resolved impurity single-particle density matrix
ρ[s1,s2,a,b] = ⟨c†_{a s1} c_{b s2}⟩ against one-body t2g operators:

* S(α)[a,b]   — spin vector per orbital pair,
* L(α)[s,s']  — effective l=1 (t2g: 1=yz, 2=zx, 3=xy) OAM per spin pair,
* j(α)        — tr(ρ J_α), J = L + S,
* j²(α)       — tr(ρ J_α²) (one-body operator square, as in the reference),
* LS          — tr(ρ L·S).

The density matrix is first rotated into the {t2g, Sz} product basis; the
rotation depends on the basis the impurity problem was set up in, exactly
as in the reference (:316-333):

* replica/general bath, no jz_basis → identity (already {t2g,Sz});
* replica/general bath, jz_basis   → from {Lz,Sz};
* normal bath                      → from the atomic {J,jz} basis.

Valid only for Norb=3, Nspin=2 (the reference stops otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EDConfig

_PAULI = {
    "x": np.array([[0, 1], [1, 0]], complex),
    "y": np.array([[0, -1j], [1j, 0]], complex),
    "z": np.array([[1, 0], [0, -1]], complex),
}


def _so_from_spinfast(m6: np.ndarray) -> np.ndarray:
    """Reorder a 6x6 operator from orbital-major/spin-fast index
    (i = s + 2*a, the reference's "[Norb*Norb]*Nspin notation") to the
    orb-fast so-index (i = a + 3*s, so2os_reshape)."""
    out = np.zeros((6, 6), complex)
    for s1 in range(2):
        for a in range(3):
            for s2 in range(2):
                for b in range(3):
                    out[a + 3 * s1, b + 3 * s2] = m6[s1 + 2 * a, s2 + 2 * b]
    return out


def _hermitize_upper(m: np.ndarray) -> np.ndarray:
    """Reference idiom: fill the lower triangle with the conjugate upper."""
    out = m.copy()
    for i in range(m.shape[0]):
        for j in range(i):
            out[i, j] = np.conj(out[j, i])
    return out


def atomic_soc() -> np.ndarray:
    """L·S in the {t2g, Sz} so basis (reference atomic_SOC :147-166)."""
    m = np.zeros((6, 6), complex)
    m[0:2, 2:4] = +1j * _PAULI["z"] / 2.0
    m[0:2, 4:6] = -1j * _PAULI["y"] / 2.0
    m[2:4, 4:6] = +1j * _PAULI["x"] / 2.0
    return _so_from_spinfast(_hermitize_upper(m))


def atomic_j(component: str) -> np.ndarray:
    """J_α = L_α + S_α in the so basis (reference atomic_j :256-290)."""
    m = np.zeros((6, 6), complex)
    p = _PAULI[component] / 2.0
    for a in range(3):
        m[2 * a:2 * a + 2, 2 * a:2 * a + 2] = p
    if component == "x":
        m[2:4, 4:6] = -1j * np.eye(2)
    elif component == "y":
        m[0:2, 4:6] = +1j * np.eye(2)
    else:
        m[0:2, 2:4] = -1j * np.eye(2)
    return _so_from_spinfast(_hermitize_upper(m))


def atomic_soc_rotation() -> np.ndarray:
    """Columns = |J, jz⟩ directly in the orb-fast so basis
    (yz↑, zx↑, xy↑, yz↓, zx↓, xy↓) — the reference builds this one without
    the spin-fast reorder (atomic_SOC_rotation :168-210: rows 1,2,6 of the
    jz=-1/2 column are yz↑, zx↑, xy↓)."""
    u = np.zeros((6, 6), complex)
    s3, s2, s6 = np.sqrt(3.0), np.sqrt(2.0), np.sqrt(6.0)
    # J=1/2, jz=-1/2
    u[0, 0], u[1, 0], u[5, 0] = 1.0 / s3, -1j / s3, -1.0 / s3
    # J=1/2, jz=+1/2
    u[3, 1], u[4, 1], u[2, 1] = 1.0 / s3, +1j / s3, 1.0 / s3
    # J=3/2, jz=-3/2
    u[3, 2], u[4, 2] = 1.0 / s2, -1j / s2
    # J=3/2, jz=+3/2
    u[0, 3], u[1, 3] = -1.0 / s2, -1j / s2
    # J=3/2, jz=-1/2
    u[0, 4], u[1, 4], u[5, 4] = 1.0 / s6, -1j / s6, 2.0 / s6
    # J=3/2, jz=+1/2
    u[3, 5], u[4, 5], u[2, 5] = -1.0 / s6, -1j / s6, 2.0 / s6
    return u


def orbital_lz_rotation() -> np.ndarray:
    """{t2g} → {Lz} orbital rotation ⊗ spin identity, so-indexed
    (reference orbital_Lz_rotation_NorbNspin :231-253)."""
    u3 = np.zeros((3, 3), complex)
    u3[0, 0] = -1j / np.sqrt(2.0)
    u3[1, 1] = +1.0 / np.sqrt(2.0)
    u3[2, 2] = +1j
    u3[0, 1] = -1j / np.sqrt(2.0)
    u3[1, 0] = -1.0 / np.sqrt(2.0)
    out = np.zeros((6, 6), complex)
    out[0:3, 0:3] = u3
    out[3:6, 3:6] = u3
    return out


@dataclass
class SOCOperators:
    """Getter payload (reference Simp/Limp/Jimp/Jimp_sq/LSimp)."""
    s_imp: np.ndarray     # (3, Norb, Norb) ⟨S_α⟩ per orbital pair
    l_imp: np.ndarray     # (3, Nspin, Nspin) ⟨L_α⟩ per spin pair
    j_imp: np.ndarray     # (3,) tr(ρ J_α)
    j_imp_sq: np.ndarray  # (3,) tr(ρ J_α²)
    ls_imp: complex       # tr(ρ L·S)


def quantum_soc_operators(cfg: EDConfig, rho_nn: np.ndarray) -> SOCOperators:
    """Compute the SOC operator expectations from the spin-resolved
    impurity density matrix ρ[s1,s2,a,b] = ⟨c†_{a s1} c_{b s2}⟩
    (reference ed_get_quantum_SOC_operators_single :289-400)."""
    if cfg.norb != 3:
        raise ValueError("SOC operators implemented only for 3 orbitals")
    if cfg.nspin != 2:
        raise ValueError("SOC operators implemented only for 2 spins")
    rho_nn = np.asarray(rho_nn, complex)
    # nn → so (io = a + 3*s)
    rho_so = np.zeros((6, 6), complex)
    for s1 in range(2):
        for s2 in range(2):
            rho_so[3 * s1:3 * s1 + 3, 3 * s2:3 * s2 + 3] = rho_nn[s1, s2]
    # rotation into {t2g, Sz} (reference :316-333; hybrid/general follow
    # the replica contract — the dm is already in {t2g,Sz} unless jz_basis)
    if cfg.bath_type == "normal":
        u = atomic_soc_rotation().conj().T
    elif cfg.jz_basis:
        u = orbital_lz_rotation().conj().T
    else:
        u = np.eye(6, dtype=complex)
    rho_so = u.conj().T @ rho_so @ u
    rho = np.zeros((2, 2, 3, 3), complex)
    for s1 in range(2):
        for s2 in range(2):
            rho[s1, s2] = rho_so[3 * s1:3 * s1 + 3, 3 * s2:3 * s2 + 3]

    s_imp = np.zeros((3, 3, 3), complex)
    for a in range(3):
        for b in range(3):
            s_imp[0, a, b] = 0.5 * (rho[0, 1, a, b] + rho[1, 0, a, b])
            s_imp[1, a, b] = 0.5j * (rho[1, 0, a, b] - rho[0, 1, a, b])
            s_imp[2, a, b] = 0.5 * (rho[0, 0, a, b] - rho[1, 1, a, b])
    l_imp = np.zeros((3, 2, 2), complex)
    for s1 in range(2):
        for s2 in range(2):
            l_imp[0, s1, s2] = 1j * (rho[s1, s2, 2, 1] - rho[s1, s2, 1, 2])
            l_imp[1, s1, s2] = 1j * (rho[s1, s2, 0, 2] - rho[s1, s2, 2, 0])
            l_imp[2, s1, s2] = 1j * (rho[s1, s2, 1, 0] - rho[s1, s2, 0, 1])
    # ⟨O_M⟩ = Σ_ij M_ij ⟨c†_i c_j⟩ = Σ_ij M_ij ρ_ij.  NOTE an intentional
    # divergence: the reference contracts trace(matmul(rho_so, M))
    # (:380-397), which against its own ρ_ij = ⟨c†_i c_j⟩ convention
    # evaluates ⟨conj(M)⟩ — for a genuinely complex ρ that is unphysical
    # (the filled J=3/2 quartet must give ⟨L·S⟩ = −2; the transposed trace
    # gives +2/3).  The two agree whenever ρ is real-symmetric.
    def expect(m):
        return complex(np.sum(rho_so * m))

    j_imp = np.zeros(3, complex)
    j_imp_sq = np.zeros(3, complex)
    for k, comp in enumerate("xyz"):
        jm = atomic_j(comp)
        j_imp[k] = expect(jm)
        j_imp_sq[k] = expect(jm @ jm)
    ls = expect(atomic_soc())
    return SOCOperators(s_imp, l_imp, j_imp, j_imp_sq, ls)
