"""Carry state across from edipack_tpu without importing it.

Both functions take plain Python / NumPy values, so a caller (or a test)
can build an edipack_tpu solver and an edipack_tpu_torch solver from the
same numbers. Packed bath arrays share one layout in both packages, in
every ed_mode (normal, superc, nonsu2) and bath_type (normal, hybrid,
replica, general), and so do the restart files (``hamiltonian.restart``,
``state_list.restart``, ``sectors.restart``, ``xmu.restart`` and the
replica basis ``<bfile>.restart``): ``ed_init_solver`` / ``ed_solve`` /
``ed_search_variable`` read the ones edipack_tpu wrote, as they are. The
same holds for the stores of the extras: ``ed_read_*chimatrix`` reads the
``chimatrix<suffix>.npz`` that edipack_tpu's ``ed_solve`` writes (and
``ed_read_impgmatrix`` its ``gfmatrix<suffix>.npz``), and
``ed_read_umatrix_file`` and the ``ed_read_umatrix`` input read a umatrix
file that edipack_tpu's ``ed_save_umatrix_file`` wrote
(tests/test_torch_chi.py, tests/test_torch_extras_api.py,
tests/test_torch_joint_api.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from typing import Optional

from .bath.dmft_bath import DmftBath, array_to_bath
from .bath.replica import ReplicaBasis
from .config import EDConfig


def config_from_jax(cfg_dict: dict) -> EDConfig:
    """``dataclasses.asdict(edipack_tpu EDConfig)`` -> this package's
    EDConfig (the two dataclasses share their field names)."""
    names = {f.name for f in dataclasses.fields(EDConfig)}
    unknown = set(cfg_dict) - names
    if unknown:
        raise ValueError(f"config_from_jax: unknown fields {sorted(unknown)}")
    cfg = EDConfig(**cfg_dict)
    cfg.validate()
    return cfg


def bath_from_array(bath_array: np.ndarray, cfg: EDConfig,
                    basis: Optional[ReplicaBasis] = None) -> DmftBath:
    """Packed reference-layout bath (edipack_tpu ``bath_to_array``) ->
    this package's DmftBath; replica/general baths need their ``basis``
    (``ReplicaBasis(ops, linit)`` of the edipack_tpu basis's arrays)."""
    return array_to_bath(np.asarray(bath_array, np.float64), cfg, basis)
