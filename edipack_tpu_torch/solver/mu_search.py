"""Fixed-density chemical-potential controller.

Parity target: reference `search_chemical_potential`
(ED_AUX_FUNX.f90:1360-1516): monotone xmu adjustment toward `nread` with an
oscillation-damped step, a shrinking density threshold ladder (nth from
1e-2 down to nerr), convergence gating of the DMFT loop, and persistence
through `xmu.restart` / `search_mu_iteration.ed`; counterpart of
edipack_tpu.solver.mu_search (plain NumPy, kept as this package's own copy).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..config import EDConfig
from ..parallel.mesh import is_writer


@dataclass
class MuSearchState:
    ndelta: float
    count: int = 0
    nindex: int = 0
    nindex_old: list = field(default_factory=lambda: [0, 0, 0])
    nth_magnitude: int = -2
    nth_magnitude_old: int = -2
    nth: float = 1e-2
    ireduce: bool = True


_state: MuSearchState = None


def _init_state(cfg: EDConfig) -> MuSearchState:
    """Fresh controller state; adopts xmu.restart's ndelta when present
    (reference ED_INPUT_VARS.f90:861-870 semantics via ncoeff)."""
    ndelta = cfg.ndelta
    path = os.path.join(cfg.ed_output_dir, "xmu.restart")
    if os.path.exists(path):
        parts = open(path).read().split()
        if len(parts) >= 2:
            ndelta = abs(float(parts[1])) * cfg.ncoeff
    return MuSearchState(ndelta=ndelta)


def read_xmu_start(cfg: EDConfig) -> float:
    """Starting chemical potential: xmu.restart if present, else cfg.xmu."""
    path = os.path.join(cfg.ed_output_dir, "xmu.restart")
    if os.path.exists(path):
        parts = open(path).read().split()
        if parts:
            return float(parts[0])
    return cfg.xmu


def search_variable(cfg: EDConfig, var: float, ntmp: float, converged: bool):
    """One controller step (reference search_chemical_potential). Returns
    (new_var, converged) and persists xmu.restart + search_mu_iteration.ed."""
    global _state
    if cfg.nread == 0.0:
        return var, converged
    if _state is None:
        _state = _init_state(cfg)
    st = _state
    ndiff = ntmp - cfg.nread
    nratio = 0.5

    st.count += 1
    st.nindex_old = [st.nindex] + st.nindex_old[:2]
    if ndiff >= st.nth:
        st.nindex = -1
    elif ndiff <= -st.nth:
        st.nindex = 1
    else:
        st.nindex = 0

    ndelta_old = st.ndelta
    # damp fore-and-back oscillation: looking back one step or the whole
    # 3-step window (:1432-1438)
    osc = st.nindex != 0 and (
        st.nindex + st.nindex_old[0] == 0
        or st.nindex + sum(st.nindex_old) == 0)
    if osc:
        st.ndelta = ndelta_old * nratio
    if abs(ndelta_old) < 1e-9:
        st.nindex = 0

    var = var + st.nindex * st.ndelta

    if is_writer():
        try:
            with open(os.path.join(cfg.ed_output_dir,
                                   "search_mu_iteration"
                                   + cfg.ed_file_suffix + ".ed"), "a") as fh:
                fh.write(f"{var:.12f} {ntmp:.12f} {ndiff:.12e}\n")
        except OSError:
            pass

    # threshold-ladder annealing (:1470-1486): once converged within the
    # current (coarser) threshold, tighten it one decade and force another
    # loop round
    if st.ireduce and abs(ndiff) < st.nth and converged and st.nth > cfg.nerr:
        st.nth_magnitude_old = st.nth_magnitude
        st.nth_magnitude -= 1
        st.nth = max(cfg.nerr, 10.0 ** st.nth_magnitude)
        st.count = 0
        converged = False
        st.ndelta = ndelta_old * nratio
    if abs(ndiff) > st.nth:
        converged = False
    # give up tightening after too many rounds at one threshold (:1494-1499)
    if st.ireduce and st.count > cfg.cg_niter and not converged:
        st.ireduce = False
        st.nth = 10.0 ** st.nth_magnitude_old

    if is_writer():
        try:
            with open(os.path.join(cfg.ed_output_dir, "xmu.restart"),
                      "w") as fh:
                fh.write(f"{var:.12f} {st.ndelta:.12e}\n")
        except OSError:
            pass
    return var, converged


def reset_search():
    global _state
    _state = None
