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

from . import io as edio
from .bath.dmft_bath import (array_to_bath, bath_to_array, get_bath_dimension,
                             init_bath)
from .bath.user import get_global_basis
from .config import EDConfig, get_config, set_config
from .device import resolve_device
from .sectors import SectorTable
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

    # -- lifecycle ------------------------------------------------------
    def init_solver(self, bath_array: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Initialize (or adopt) the bath; returns the packed bath array."""
        if bath_array is not None and np.asarray(bath_array).size \
                == get_bath_dimension(self.cfg) \
                and np.any(np.asarray(bath_array) != 0):
            self.bath = array_to_bath(bath_array, self.cfg)
        else:
            # the default bath, overridden by <hfile><suffix>.restart when
            # that file exists (reference init_dmft_bath)
            self.bath = init_bath(self.cfg, restart_file=self.cfg.hfile
                                  + self.cfg.ed_file_suffix + ".restart")
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
        sector_mask = None
        if neigen is None or self.cfg.ed_sectors:
            table = SectorTable(self.cfg)
            if neigen is None:
                # a previous run's state_list.restart seeds neigen_sector
                neigen = edio.read_state_list_restart(self.cfg, table)
            if self.cfg.ed_sectors:
                sector_mask = edio.read_sectors_restart(self.cfg, table)
        um = build_umatrix(self.cfg)
        self.result = solve_impurity(self.cfg, self.hloc, um, self.bath,
                                     self.device, neigen_override=neigen,
                                     sector_mask=sector_mask,
                                     flag_gf=flag_gf)
        if self.cfg.ed_write_files:
            edio.write_all_outputs(self.cfg, self.result)
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


def ed_get_g0and(zeta, bath=None, axis="m", typ="n"):
    """Evaluate the Anderson Weiss field; with an explicit packed ``bath``
    array the evaluation uses that bath (and the current global config)
    instead of the solved one (reference ed_get_g0and signature)."""
    if bath is None:
        return _R().get_g0and(zeta, axis, typ)
    from .bath.functions import g0and_bath
    cfg = get_config()
    b = array_to_bath(np.asarray(bath, float), cfg, get_global_basis())
    return g0and_bath(cfg, b, _S().hloc, np.asarray(zeta, complex))


def ed_get_delta(zeta, bath=None, axis="m", typ="n"):
    """Δ(z) of the solved bath, or of an explicit packed ``bath`` array."""
    if bath is None:
        return _R().get_delta(zeta, axis, typ)
    from .bath.functions import delta_bath, fdelta_bath
    cfg = get_config()
    b = array_to_bath(np.asarray(bath, float), cfg, get_global_basis())
    fn = delta_bath if typ == "n" else fdelta_bath
    return fn(cfg, b, np.asarray(zeta, complex))


# -- DMFT loop helpers --------------------------------------------------------


def ed_chi2_fitgf(func, bath, ispin=1, iorb=None, fmpi=True):
    """Bath fit on the packed user array (reference ed_chi2_fitgf,
    ED_FIT/ED_BATH_FIT.f90:29-55), with the current global config
    (``ed_read_input`` / ``set_config``), as edipack_tpu does. The χ² runs
    on host CPU tensors whatever the solver's device (bath/fit.py)."""
    from .bath.fit import chi2_fitgf
    return chi2_fitgf(get_config(), np.asarray(func), np.asarray(bath, float),
                      ispin=ispin, iorb=iorb, basis=get_global_basis())


def ed_search_variable(var: float, ntmp: float, converged: bool):
    """Chemical-potential search helper (reference ed_search_variable /
    search_chemical_potential, ED_AUX_FUNX.f90:1228-1516): adjust ``var``
    toward the target density cfg.nread given the measured density ``ntmp``."""
    from .solver.mu_search import search_variable
    return search_variable(get_config(), var, ntmp, converged)


def ed_search_chemical_potential(xmu: float, ntmp: float, converged: bool):
    """Adjust the chemical potential toward cfg.nread (reference
    search_chemical_potential, ED_AUX_FUNX.f90:1360-1516)."""
    return ed_search_variable(xmu, ntmp, converged)


# DMFT-loop convergence helper (consumes dmft_error / nsuccess, the knobs the
# reference exports for the user loop, doc/quickstart/02_dmft.f90:99-104)
_conv_state = {"prev": None, "count": 0}


def ed_check_convergence(func, threshold: Optional[float] = None,
                         nsuccess: Optional[int] = None):
    """Relative-change convergence check for the user's DMFT loop:
    err = max |func - func_prev| / max(|func|, 1e-12); converged once err <
    threshold (default cfg.dmft_error) for ``nsuccess`` (default
    cfg.nsuccess) successive calls. Returns (err, converged)."""
    cfg = get_config()
    thr = cfg.dmft_error if threshold is None else threshold
    need = cfg.nsuccess if nsuccess is None else nsuccess
    f = np.asarray(func)
    prev = _conv_state["prev"]
    if prev is None or prev.shape != f.shape:
        err = 1.0
    else:
        scale = max(float(np.abs(f).max()), 1e-12)
        err = float(np.abs(f - prev).max()) / scale
    _conv_state["prev"] = f.copy()
    if err < thr:
        _conv_state["count"] += 1
    else:
        _conv_state["count"] = 0
    return err, _conv_state["count"] >= need


def ed_reset_convergence() -> None:
    _conv_state["prev"] = None
    _conv_state["count"] = 0


# -- suffix management, GFmatrix store, build-on-grid aliases ----------------


def ed_set_suffix(suffix) -> None:
    """Per-site file suffix (reference ed_set_suffix, ED_AUX_FUNX): integer
    arguments are formatted like the reference's ineq-site suffix."""
    s = f"_ineq{int(suffix):04d}" if isinstance(suffix, (int, np.integer)) \
        else str(suffix)
    set_config(get_config().replace(ed_file_suffix=s))
    if _solver is not None:
        _solver.cfg = _solver.cfg.replace(ed_file_suffix=s)


def ed_reset_suffix() -> None:
    ed_set_suffix("")


def ed_read_impgmatrix(path: Optional[str] = None):
    """Reload the Källén-Lehmann GF store written by a previous solve so
    G/Σ/D can be re-evaluated on any grid without re-solving (reference
    ed_read_ImpGMatrix -> read_GFmatrix, ED_GFMATRIX.f90:78-107)."""
    from .solver.greens import GFMatrix
    cfg = get_config()
    gf = GFMatrix.load(path or os.path.join(
        cfg.ed_output_dir, f"gfmatrix{cfg.ed_file_suffix}.npz"))
    s = _S()
    if s.result is not None:
        s.result.gf = gf
    s.loaded_gf = gf
    return gf


def ed_build_impg(zeta, axis="m"):
    return ed_get_gimp(zeta, axis, typ="n")


def ed_build_sigma(zeta, axis="m"):
    return ed_get_sigma(zeta, axis, typ="n")
