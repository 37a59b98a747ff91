"""The effective bath: allocation, default init, user-array pack/unpack, IO.

Parity targets: reference ED_BATH/ED_BATH_DMFT.f90 (allocate :24-134,
init :178-307, set_dmft_bath :679-887, get_dmft_bath :891-1095) and
ED_BATH/ED_BATH_DIM.f90 (get_bath_dimension).

The user-facing bath is a flat float64 vector whose layout matches the
reference exactly (so programs written against EDIpack's bath arrays work
unchanged):

  normal bath  : [e(s,o,k)... , (d(s,o,k)... if superc), v(s,o,k)...,
                  (u(s,o,k)... if nonsu2)]                    (C-order s,o,k)
  hybrid bath  : e has a single orbital slot: e(s,1,k)
  replica      : [Nbasis, (v_k, lambda_k(1:Nbasis))_{k=1..Nbath}]
  general      : [Nbasis, (vg_k(1:Nspin*Norb), lambda_k(1:Nbasis))_{k=1..Nbath}]
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import EDConfig
from .replica import ReplicaBasis


@dataclass
class DmftBath:
    cfg: EDConfig
    # normal/hybrid components (Nspin, Norb|1, Nbath)
    e: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    d: Optional[np.ndarray] = None   # superc pair amplitudes
    u: Optional[np.ndarray] = None   # nonsu2 spin-flip hybridization
    # replica/general components
    basis: Optional[ReplicaBasis] = None
    lambdas: Optional[np.ndarray] = None  # (Nbath, Nsym)
    vs: Optional[np.ndarray] = None       # (Nbath,) replica | (Nbath, Nspin*Norb) general

    # ------------------------------------------------------------------
    @property
    def is_replica(self) -> bool:
        return self.cfg.bath_type in ("replica", "general")

    def hbath(self) -> np.ndarray:
        """Per-replica bath Hamiltonians H_k = sum_s lambda_k(s) O_s,
        shape (Nbath, Nspin, Nspin, Norb, Norb)."""
        assert self.is_replica
        return np.einsum("ks,sabij->kabij", self.lambdas, self.basis.ops)

    def hyb(self, ibath: int) -> np.ndarray:
        """Hybridization amplitudes of replica ``ibath`` as (Nspin*Norb,)."""
        cfg = self.cfg
        if cfg.bath_type == "replica":
            return np.full(cfg.nspin * cfg.norb, self.vs[ibath])
        return self.vs[ibath]

    # ------------------------------------------------------------------
    def copy(self) -> "DmftBath":
        out = DmftBath(self.cfg)
        for name in ("e", "v", "d", "u", "lambdas", "vs"):
            val = getattr(self, name)
            setattr(out, name, None if val is None else val.copy())
        out.basis = self.basis
        return out


# ---------------------------------------------------------------------------


def get_bath_dimension(cfg: EDConfig, basis: Optional[ReplicaBasis] = None) -> int:
    """Length of the packed user bath array (reference get_bath_dimension,
    ED_BATH_DIM.f90:36-37)."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    bt, mode = cfg.bath_type, cfg.ed_mode
    if bt == "normal":
        per = {"normal": 2, "superc": 3, "nonsu2": 3}[mode]
        return per * ns * no * nb
    if bt == "hybrid":
        e_sz = ns * nb
        v_sz = ns * no * nb
        if mode == "normal":
            return e_sz + v_sz
        if mode == "superc":
            return 2 * e_sz + v_sz
        return e_sz + 2 * v_sz
    if basis is None:
        raise ValueError("replica/general bath dimension requires the matrix basis "
                         "(call ed_set_hreplica/ed_set_hgeneral first)")
    nsym = basis.nsym
    if bt == "replica":
        return 1 + nb * (1 + nsym)
    return 1 + nb * (ns * no + nsym)


def allocate_bath(cfg: EDConfig, basis: Optional[ReplicaBasis] = None) -> DmftBath:
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    b = DmftBath(cfg)
    if cfg.bath_type in ("normal", "hybrid"):
        no_e = no if cfg.bath_type == "normal" else 1
        b.e = np.zeros((ns, no_e, nb))
        b.v = np.zeros((ns, no, nb))
        if cfg.ed_mode == "superc":
            b.d = np.zeros((ns, no_e if cfg.bath_type == "hybrid" else no, nb))
        if cfg.ed_mode == "nonsu2":
            b.u = np.zeros((ns, no, nb))
    else:
        if basis is None:
            raise ValueError("replica/general bath requires a matrix basis")
        b.basis = basis
        b.lambdas = np.zeros((nb, basis.nsym))
        if cfg.bath_type == "replica":
            b.vs = np.zeros(nb)
        else:
            b.vs = np.zeros((nb, ns * no))
    return b


def _flat_band_levels(nbath: int, hw: float) -> np.ndarray:
    """Centered discretization of a flat band of half-width hw
    (reference init_dmft_bath, ED_BATH_DMFT.f90:212-233)."""
    e = np.zeros(nbath)
    if nbath == 0:
        return e
    e[0], e[-1] = -hw, hw
    nh = nbath // 2
    if nbath % 2 == 0 and nbath >= 4:
        de = hw / max(nh - 1, 1)
        e[nh - 1], e[nh] = -0.1, 0.1
        for i in range(2, nh):
            e[i - 1] = -hw + (i - 1) * de
            e[nbath - i] = hw - (i - 1) * de
    elif nbath % 2 == 1 and nbath >= 3:
        de = hw / nh
        e[nh] = 0.0
        for i in range(2, nh + 1):
            e[i - 1] = -hw + (i - 1) * de
            e[nbath - i] = hw - (i - 1) * de
    return e


def init_bath(cfg: EDConfig, basis: Optional[ReplicaBasis] = None,
              restart_file: Optional[str] = None) -> DmftBath:
    """Default-initialize the bath (reference init_dmft_bath), optionally
    overridden by a ``hamiltonian.restart`` file."""
    b = allocate_bath(cfg, basis)
    nb = cfg.nbath
    if nb == 0:
        return b
    if not b.is_replica:
        b.e[:] = _flat_band_levels(nb, cfg.ed_hw_bath)[None, None, :]
        b.v[:] = max(0.1, 1.0 / np.sqrt(nb))
        if b.d is not None:
            b.d[:] = cfg.deltasc
        if b.u is not None:
            b.u[:] = b.v
    else:
        b.vs[...] = max(0.1, 1.0 / np.sqrt(nb))
        b.lambdas[:] = basis.linit.copy()
        offset = (np.linspace(-cfg.ed_offset_bath, cfg.ed_offset_bath, nb)
                  if nb > 1 else np.zeros(1))
        for isym in range(basis.nsym):
            diag = basis.is_diagonal(isym)
            equal = np.all(basis.linit[:, isym] == basis.linit[-1, isym])
            if diag and equal and nb > 1:
                off = offset.copy()
                if basis.is_identity(isym) and nb % 2 == 0:
                    off[nb // 2 - 1] = max(-0.1, off[nb // 2 - 1])
                    off[nb // 2] = min(0.1, off[nb // 2])
                b.lambdas[:, isym] = basis.linit[:, isym] + off
    if restart_file is not None:
        import os
        if os.path.exists(restart_file):
            read_bath_file(b, restart_file)
    return b


# ---------------------------------------------------------------------------
# pack / unpack (reference get_dmft_bath / set_dmft_bath)
# ---------------------------------------------------------------------------


def bath_to_array(b: DmftBath) -> np.ndarray:
    cfg = b.cfg
    if not b.is_replica:
        parts = [b.e.ravel()]
        if cfg.ed_mode == "superc":
            parts.append(b.d.ravel())
        parts.append(b.v.ravel())
        if cfg.ed_mode == "nonsu2":
            parts.append(b.u.ravel())
        return np.concatenate(parts)
    parts = [np.array([float(b.basis.nsym)])]
    for k in range(cfg.nbath):
        if cfg.bath_type == "replica":
            parts.append(np.array([b.vs[k]]))
        else:
            parts.append(np.asarray(b.vs[k]).ravel())
        parts.append(b.lambdas[k])
    return np.concatenate(parts)


def array_to_bath(arr: np.ndarray, cfg: EDConfig,
                  basis: Optional[ReplicaBasis] = None) -> DmftBath:
    arr = np.asarray(arr, dtype=np.float64).ravel()
    expect = get_bath_dimension(cfg, basis)
    if arr.size != expect:
        raise ValueError(f"bath array has size {arr.size}, expected {expect}")
    b = allocate_bath(cfg, basis)
    if not b.is_replica:
        pos = 0

        def take(shape):
            nonlocal pos
            n = int(np.prod(shape))
            out = arr[pos:pos + n].reshape(shape)
            pos += n
            return out

        b.e[:] = take(b.e.shape)
        if cfg.ed_mode == "superc":
            b.d[:] = take(b.d.shape)
        b.v[:] = take(b.v.shape)
        if cfg.ed_mode == "nonsu2":
            b.u[:] = take(b.u.shape)
        return b
    nsym = int(round(arr[0]))
    if nsym != basis.nsym:
        raise ValueError(f"bath Nbasis {nsym} != basis Nsym {basis.nsym}")
    pos = 1
    for k in range(cfg.nbath):
        if cfg.bath_type == "replica":
            b.vs[k] = arr[pos]
            pos += 1
        else:
            n = cfg.nspin * cfg.norb
            b.vs[k] = arr[pos:pos + n]
            pos += n
        b.lambdas[k] = arr[pos:pos + nsym]
        pos += nsym
    return b


# ---------------------------------------------------------------------------
# bath restart files (reference read/write_dmft_bath; simple text format)
# ---------------------------------------------------------------------------


def save_bath_file(b: DmftBath, path: str) -> None:
    np.savetxt(path, bath_to_array(b)[None, :])


def read_bath_file(b: DmftBath, path: str) -> DmftBath:
    arr = np.loadtxt(path).ravel()
    nb = array_to_bath(arr, b.cfg, b.basis)
    for name in ("e", "v", "d", "u", "lambdas", "vs"):
        val = getattr(nb, name)
        if val is not None:
            setattr(b, name, val)
    return b


# ---------------------------------------------------------------------------
# per-spin level arrays for the Hamiltonian builders
# (reference ED_NORMAL/diag_hybr_bath.f90: diag_hybr / bath_diag)
# ---------------------------------------------------------------------------


def bath_levels(b: DmftBath) -> np.ndarray:
    """bath_diag(ispin, iorb_slot, k): onsite bath energies; for replica the
    diagonal (per-spin, per-orbital) of H_k."""
    cfg = b.cfg
    if not b.is_replica:
        return b.e
    hb = b.hbath()  # (Nbath, Nspin, Nspin, Norb, Norb)
    diag = np.einsum("kaaii->aik", hb).real  # (Nspin, Norb, Nbath)
    return diag


def bath_hyb(b: DmftBath) -> np.ndarray:
    """diag_hybr(ispin, iorb, k): impurity-bath hybridization amplitudes."""
    cfg = b.cfg
    if not b.is_replica:
        return b.v
    out = np.zeros((cfg.nspin, cfg.norb, cfg.nbath))
    for k in range(cfg.nbath):
        out[:, :, k] = b.hyb(k).reshape(cfg.nspin, cfg.norb)
    return out
