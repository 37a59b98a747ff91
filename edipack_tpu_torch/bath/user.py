"""User-facing bath manipulations on the packed bath array.

Parity target: reference ED_BATH/ED_BATH_USER.f90 (:116-125): symmetry
operations user programs apply between DMFT iterations, plus the global
replica/general matrix-basis setters (ED_BATH_REPLICA.f90:124-145,
reference `ed_set_Hreplica`/`ed_set_Hgeneral`); counterpart of
edipack_tpu.bath.user (plain NumPy, kept as this package's own copy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import EDConfig, get_config
from .dmft_bath import array_to_bath, bath_to_array
from .replica import ReplicaBasis, make_basis

# module-level basis store (the reference keeps Hb as a Fortran global)
_global_basis: Optional[ReplicaBasis] = None


def ed_set_hreplica(hvec, lambdavec, nbath: Optional[int] = None) -> ReplicaBasis:
    """Install the replica-bath matrix basis. ``hvec``: (Nsym,Nspin,Nspin,
    Norb,Norb) (or flattened (Nsym, Nspin*Norb, Nspin*Norb)); ``lambdavec``:
    (Nbath,Nsym) or (Nsym,)."""
    global _global_basis
    cfg = get_config()
    hvec = np.asarray(hvec)
    if hvec.ndim == 3:  # (Nsym, Nspin*Norb, Nspin*Norb)
        ns, no = cfg.nspin, cfg.norb
        hvec = hvec.reshape(-1, ns, no, ns, no).transpose(0, 1, 3, 2, 4)
    _global_basis = make_basis(hvec, lambdavec, nbath=nbath or cfg.nbath)
    return _global_basis


ed_set_hgeneral = ed_set_hreplica


def ed_set_linit_hreplica(lvec) -> None:
    """Set the initial lambda vector of the installed replica/general basis
    (reference set_linit_Hreplica, ED_BATH_REPLICA.f90:448-460;
    lvec: (Nbath, Nsym))."""
    if _global_basis is None:
        raise RuntimeError("set_linit: install a basis with ed_set_hreplica "
                           "first (reference Hb%status=F stop)")
    lvec = np.asarray(lvec, float)
    nb, nsym = _global_basis.linit.shape
    if lvec.shape != (nb, nsym):
        raise ValueError(f"linit shape {lvec.shape} != ({nb},{nsym})")
    _global_basis.linit = lvec


ed_set_linit_hgeneral = ed_set_linit_hreplica


def ed_set_hsym_hreplica(isym: int, hsym) -> None:
    """Replace basis matrix ``isym`` (1-based) of the installed
    replica/general basis (reference set_hsym_Hreplica,
    ED_BATH_REPLICA.f90:463-478; hsym: (Nspin,Nspin,Norb,Norb))."""
    if _global_basis is None:
        raise RuntimeError("set_hsym: install a basis with ed_set_hreplica "
                           "first")
    h = np.asarray(hsym, complex)
    ops = _global_basis.ops
    tgt = ops[isym - 1]
    if h.size != tgt.size:
        raise ValueError(f"hsym size {h.shape} incompatible with basis "
                         f"op shape {tgt.shape}")
    ops[isym - 1] = h.reshape(tgt.shape)


ed_set_hsym_hgeneral = ed_set_hsym_hreplica


def ed_read_dmft_bath(bath_array=None, cfg=None):
    """Read the bath from <hfile><suffix>.restart into the packed user
    array (reference read_dmft_bath, ED_BATH_DMFT.f90); returns the packed
    array."""
    from .dmft_bath import (array_to_bath, bath_to_array, init_bath,
                            read_bath_file)
    cfg = cfg or get_config()
    path = cfg.hfile + cfg.ed_file_suffix + ".restart"
    b = init_bath(cfg, basis=_global_basis) if bath_array is None \
        else array_to_bath(np.asarray(bath_array, float), cfg, _global_basis)
    b = read_bath_file(b, path)
    return bath_to_array(b)


def get_global_basis() -> Optional[ReplicaBasis]:
    return _global_basis


def clear_global_basis() -> None:
    global _global_basis
    _global_basis = None


def _set_global_basis(basis: ReplicaBasis) -> None:
    global _global_basis
    _global_basis = basis


# ---------------------------------------------------------------------------
# packed-array symmetrizations (normal/hybrid baths)
# ---------------------------------------------------------------------------


def _with_bath(bath_array, fn, cfg=None):
    cfg = cfg or get_config()
    b = array_to_bath(np.asarray(bath_array, float), cfg, _global_basis)
    fn(b)
    return bath_to_array(b)


def ed_spin_symmetrize_bath(bath_array, save: bool = False, cfg=None):
    """Copy the spin-up bath into spin-down (reference spin_symmetrize_bath)."""
    def fn(b):
        if b.is_replica:
            raise ValueError("spin_symmetrize undefined for replica bath")
        for arr in (b.e, b.v, b.d, b.u):
            if arr is not None and arr.shape[0] > 1:
                arr[1] = arr[0]
    return _with_bath(bath_array, fn, cfg)


def ed_orb_symmetrize_bath(bath_array, orb1: Optional[int] = None,
                           orb2: Optional[int] = None, save: bool = False,
                           cfg=None):
    """Average bath parameters over orbitals (all, or the given 1-based pair)."""
    def fn(b):
        if b.is_replica:
            raise ValueError("orb_symmetrize undefined for replica bath")
        for arr in (b.e, b.v, b.d, b.u):
            if arr is None or arr.shape[1] == 1:
                continue
            if orb1 is None:
                arr[:, :, :] = arr.mean(axis=1, keepdims=True)
            else:
                avg = 0.5 * (arr[:, orb1 - 1] + arr[:, orb2 - 1])
                arr[:, orb1 - 1] = avg
                arr[:, orb2 - 1] = avg
    return _with_bath(bath_array, fn, cfg)


def ed_orb_equality_bath(bath_array, indx: int = 1, save: bool = False, cfg=None):
    """Set every orbital's bath equal to that of orbital ``indx`` (1-based)."""
    def fn(b):
        if b.is_replica:
            raise ValueError("orb_equality undefined for replica bath")
        for arr in (b.e, b.v, b.d, b.u):
            if arr is None or arr.shape[1] == 1:
                continue
            arr[:, :, :] = arr[:, indx - 1: indx, :]
    return _with_bath(bath_array, fn, cfg)


def ed_break_symmetry_bath(bath_array, field: float, sign: float = 1.0,
                           save: bool = False, cfg=None):
    """Shift up/down bath levels by ±field*sign to seed magnetic solutions
    (reference break_symmetry_bath)."""
    def fn(b):
        if b.is_replica:
            raise ValueError("break_symmetry undefined for replica bath")
        b.e[0] += sign * field
        b.e[-1] -= sign * field
    return _with_bath(bath_array, fn, cfg)


def ed_ph_symmetrize_bath(bath_array, save: bool = False, cfg=None):
    """Enforce particle-hole symmetry: levels in ± pairs (reference
    ph_symmetrize_bath)."""
    def fn(b):
        if b.is_replica:
            raise ValueError("ph_symmetrize undefined for replica bath")
        nb = b.e.shape[2]
        for i in range(nb // 2):
            b.e[:, :, nb - 1 - i] = -b.e[:, :, i]
            b.v[:, :, nb - 1 - i] = b.v[:, :, i]
            if b.d is not None:
                b.d[:, :, nb - 1 - i] = b.d[:, :, i]
        if nb % 2 == 1:
            b.e[:, :, nb // 2] = 0.0
    return _with_bath(bath_array, fn, cfg)


def ed_enforce_normal_bath(bath_array, save: bool = False, cfg=None):
    """Zero all superconducting amplitudes (reference enforce_normal_bath)."""
    def fn(b):
        if b.d is not None:
            b.d[:] = 0.0
    return _with_bath(bath_array, fn, cfg)


def ed_ph_trans_bath(bath_array, save: bool = False, cfg=None):
    """Particle-hole transform of the bath (reference ph_trans_bath,
    ED_BATH_USER.f90:344-381): Norb=1 negates the levels; Norb=2 swaps the
    orbital pair with a sign flip (e1 <- -e2, e2 <- -e1, V columns swapped);
    other Norb are left unchanged, matching the reference."""
    def fn(b):
        if b.is_replica:
            raise ValueError("ph_trans undefined for replica/general bath")
        no = b.e.shape[1]
        if no == 1:
            b.e[:] = -b.e
        elif no == 2:
            e = b.e.copy()
            v = b.v.copy()
            b.e[:, 0] = -e[:, 1]
            b.e[:, 1] = -e[:, 0]
            b.v[:, 0] = v[:, 1]
            b.v[:, 1] = v[:, 0]
    return _with_bath(bath_array, fn, cfg)


def ed_save_array_as_bath(bath_array, cfg=None) -> None:
    """Write the packed user bath array to the ``hamiltonian.restart`` file
    (reference save_array_as_bath, ED_BATH_USER.f90:495-501)."""
    from ..parallel.mesh import is_writer
    from .dmft_bath import save_bath_file
    cfg = cfg or get_config()
    b = array_to_bath(np.asarray(bath_array, float), cfg, _global_basis)
    if not is_writer():
        return
    save_bath_file(b, cfg.hfile + cfg.ed_file_suffix + ".restart")
