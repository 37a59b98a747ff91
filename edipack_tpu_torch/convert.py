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

A lattice (inequivalent sites) carries across the same way: the (Nineq,
Nb) stack of packed baths (:func:`baths_from_stack`), and each site's
files under the suffix ``_ineq%04d`` (sites numbered from 1):
``<hfile>_ineq0001.restart`` is read unchanged by
``EDIneqSolver.init_solver`` (each site's ``EDSolver.init_solver``) and by
:func:`read_lattice_baths`, ``state_list_ineq0001.restart`` and
``sectors_ineq0001.restart`` by the superc / nonsu2 sites' solves, as
edipack_tpu reads them (tests/test_torch_ineq.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from .bath.dmft_bath import (DmftBath, array_to_bath, bath_to_array, init_bath,
                             read_bath_file)
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


def baths_from_stack(stack: np.ndarray, cfg: EDConfig,
                     basis: Optional[ReplicaBasis] = None) -> List[DmftBath]:
    """(Nineq, Nb) stack of packed baths (edipack_tpu
    ``EDIneqSolver.init_solver``) -> one DmftBath per site."""
    return [bath_from_array(row, cfg, basis)
            for row in np.atleast_2d(np.asarray(stack, np.float64))]


def read_lattice_baths(cfg: EDConfig, nineq: int,
                       basis: Optional[ReplicaBasis] = None) -> np.ndarray:
    """The (Nineq, Nb) stack read from each site's
    ``<hfile>_ineq%04d.restart`` (the files edipack_tpu writes with
    ``ed_save_array_as_bath`` under the site's suffix); a missing file
    raises."""
    out = []
    for n in range(nineq):
        path = f"{cfg.hfile}_ineq{n + 1:04d}.restart"
        if not os.path.exists(path):
            raise FileNotFoundError(f"read_lattice_baths: no {path}")
        out.append(bath_to_array(read_bath_file(init_bath(cfg, basis=basis),
                                                path)))
    return np.stack(out)
