"""Solver lifecycle and the `ed_*` functional API (normal mode).

Parity target: reference ED_MAIN.f90 (`ed_init_solver` :90-139, `ed_solve`
:164-228, `ed_finalize_solver` :236-266); counterpart of edipack_tpu.main.
:class:`EDSolver` is the object API; the module-level `ed_*` functions
mirror the reference's global-state workflow. Every solver runs on one
explicit device (default ``"cuda"``, which raises when CUDA is absent).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from .bath.dmft_bath import (array_to_bath, bath_to_array, get_bath_dimension,
                             init_bath)
from .config import EDConfig, get_config
from .device import resolve_device
from .solver.core import (SolveResult, check_supported, not_implemented,
                          solve_impurity)
from .umatrix import build_umatrix

DeviceLike = Union[str, torch.device, None]


class EDSolver:
    """One impurity solver instance (the reference equivalent is the global
    module state between ed_init_solver / ed_finalize_solver)."""

    def __init__(self, cfg: Optional[EDConfig] = None,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg or get_config()
        self.cfg.validate()
        check_supported(self.cfg)
        self.device = resolve_device(device)
        self.hloc = np.zeros((self.cfg.nspin, self.cfg.nspin,
                              self.cfg.norb, self.cfg.norb), dtype=complex)
        # HLOCfile: a (Nspin*Norb)^2 real matrix, or two such blocks stacked
        # vertically for Re/Im, loaded unless ed_set_hloc overrides
        if self.cfg.hlocfile and os.path.exists(self.cfg.hlocfile):
            ns, no = self.cfg.nspin, self.cfg.norb
            raw = np.loadtxt(self.cfg.hlocfile, ndmin=2)
            n = ns * no
            if raw.shape == (2 * n, n):
                raw = raw[:n] + 1j * raw[n:]
            if raw.shape != (n, n):
                raise ValueError(
                    f"{self.cfg.hlocfile}: expected ({n},{n}) or (2*{n},{n})"
                    f" Hloc matrix, got {raw.shape}")
            self.hloc = np.asarray(raw, complex).reshape(
                ns, no, ns, no).transpose(0, 2, 1, 3)
            print(f"[edipack_tpu_torch] loaded local Hamiltonian from "
                  f"{self.cfg.hlocfile} (set hlocfile='' to disable; "
                  f"ed_set_hloc overrides)")
        self.result: Optional[SolveResult] = None
        self.neigen_sector_override = None

    def _restart_file(self, name: str) -> str:
        return name + self.cfg.ed_file_suffix + ".restart"

    # -- lifecycle ------------------------------------------------------
    def init_solver(self, bath_array: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Initialize (or adopt) the bath; returns the packed bath array."""
        if bath_array is not None and np.asarray(bath_array).size \
                == get_bath_dimension(self.cfg) \
                and np.any(np.asarray(bath_array) != 0):
            self.bath = array_to_bath(bath_array, self.cfg)
        else:
            if os.path.exists(self._restart_file(self.cfg.hfile)):
                raise not_implemented("bath restart files",
                                      "DMFT loop and fit")
            self.bath = init_bath(self.cfg)
        return bath_to_array(self.bath)

    def set_hloc(self, hloc: np.ndarray) -> None:
        """reference ed_set_Hloc (ED_AUX_FUNX.f90:202-274). Accepts
        (Nspin,Nspin,Norb,Norb) or (Nspin*Norb, Nspin*Norb)."""
        ns, no = self.cfg.nspin, self.cfg.norb
        h = np.asarray(hloc, dtype=complex)
        if h.shape == (ns * no, ns * no):
            h = h.reshape(ns, no, ns, no).transpose(0, 2, 1, 3)
        if h.shape != (ns, ns, no, no):
            raise ValueError(f"bad Hloc shape {h.shape}")
        if np.abs(h.imag).max() > 1e-12:
            raise not_implemented("complex Hloc in ed_mode=normal",
                                  "joint modes")
        self.hloc = h

    def solve(self, bath_array: Optional[np.ndarray] = None,
              flag_gf: bool = True) -> SolveResult:
        if bath_array is not None:
            self.bath = array_to_bath(bath_array, self.cfg)
        neigen = self.neigen_sector_override
        if neigen is None and self.result is not None:
            # successive-solve annealing (reference ed_post_diag feedback:
            # neigen_sector persists between ed_solve calls,
            # ED_DIAG_NORMAL.f90:475-517)
            neigen = self.result.diag.neigen_sector
        if neigen is None and os.path.exists(os.path.join(
                self.cfg.ed_output_dir, self._restart_file("state_list"))):
            raise not_implemented("state_list restart files",
                                  "DMFT loop and fit")
        um = build_umatrix(self.cfg)
        self.result = solve_impurity(self.cfg, self.hloc, um, self.bath,
                                     self.device, neigen_override=neigen,
                                     flag_gf=flag_gf)
        return self.result

    def finalize(self) -> None:
        self.result = None


# ---------------------------------------------------------------------------
# module-level functional API (global-state parity with the reference)
# ---------------------------------------------------------------------------

_solver: Optional[EDSolver] = None


def _S() -> EDSolver:
    if _solver is None:
        raise RuntimeError("call ed_init_solver first")
    return _solver


def _R() -> SolveResult:
    r = _S().result
    if r is None:
        raise RuntimeError("call ed_solve first")
    return r


def ed_init_solver(bath=None, cfg: Optional[EDConfig] = None,
                   device: DeviceLike = "cuda"):
    global _solver
    _solver = EDSolver(cfg, device=device)
    arr = _solver.init_solver(bath)
    if bath is not None and hasattr(bath, "__setitem__") \
            and np.asarray(bath).size == arr.size:
        np.asarray(bath)[...] = arr.reshape(np.asarray(bath).shape)
    return arr


def ed_set_hloc(hloc) -> None:
    _S().set_hloc(hloc)


def ed_solve(bath=None, flag_gf: bool = True) -> SolveResult:
    """reference ed_solve(bath, flag_gf) (ED_MAIN.f90:164)."""
    return _S().solve(np.asarray(bath, float) if bath is not None else None,
                      flag_gf=flag_gf)


def ed_finalize_solver() -> None:
    global _solver
    if _solver is not None:
        _solver.finalize()
    _solver = None


def ed_get_bath_dimension(cfg: Optional[EDConfig] = None) -> int:
    return get_bath_dimension(cfg or get_config())


def ed_get_sigma(zeta=None, axis="m", typ="n"):
    return _R().get_sigma(zeta, axis, typ)


def ed_get_gimp(zeta=None, axis="m", typ="n"):
    return _R().get_gimp(zeta, axis, typ)


def ed_get_g0imp(zeta=None, axis="m", typ="n"):
    return _R().get_g0imp(zeta, axis, typ)


def ed_get_dimp(zeta=None, axis="m"):
    return _R().get_dimp(zeta, axis)


def ed_get_dens():
    return _R().dens


def ed_get_docc():
    return _R().docc


def ed_get_mag(component="z"):
    return _R().mag[{"x": 0, "y": 1, "z": 2}[component]]


def ed_get_eimp():
    return _R().energies


def ed_get_doubles():
    return _R().doubles


def ed_get_evals():
    return _R().evals


def ed_get_neigen_sector():
    return _R().neigen_sector


def ed_set_neigen_sector(neigen):
    _S().neigen_sector_override = np.asarray(neigen, int)
