"""Solver lifecycle and the `ed_*` functional API (normal mode).

Parity target: reference ED_MAIN.f90 (`ed_init_solver` :90-139, `ed_solve`
:164-228, `ed_finalize_solver` :236-266); counterpart of edipack_tpu.main.
:class:`EDSolver` is the object API; the module-level `ed_*` functions
mirror the reference's global-state workflow. Every solver runs on one
explicit device (default ``"cuda"``, which raises when CUDA is absent).
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

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
from .umatrix import TwoBodyTerm, build_umatrix, make_term

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
        self.runtime_terms: List[TwoBodyTerm] = []
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

    def add_twobody_operator(self, oi, si, oj, sj, ok, sk, ol, sl, u) -> None:
        self.runtime_terms.append(make_term(oi, si, oj, sj, ok, sk, ol, sl, u))

    def reset_umatrix(self) -> None:
        self.runtime_terms = []

    def solve(self, bath_array: Optional[np.ndarray] = None,
              flag_gf: bool = True) -> SolveResult:
        if bath_array is not None:
            self.bath = array_to_bath(bath_array, self.cfg)
        neigen = self.neigen_sector_override
        if neigen is None and self.result is not None:
            # successive-solve annealing (reference ed_post_diag feedback:
            # neigen_sector and lanc_nstates_total persist between ed_solve
            # calls, ED_DIAG_NORMAL.f90:475-517); the adapted budget goes
            # into self.cfg here, before this solve takes its config
            neigen = self.result.diag.neigen_sector
            prev_total = self.result.diag.lanc_nstates_total
            if self.cfg.ed_finite_temp and prev_total \
                    and prev_total != self.cfg.lanc_nstates_total:
                self.cfg = self.cfg.replace(lanc_nstates_total=prev_total)
        sector_mask = None
        if neigen is None or self.cfg.ed_sectors:
            table = SectorTable(self.cfg)
            if neigen is None:
                # a previous run's state_list.restart seeds neigen_sector
                neigen = edio.read_state_list_restart(self.cfg, table)
            if self.cfg.ed_sectors:
                sector_mask = edio.read_sectors_restart(self.cfg, table)
        um = build_umatrix(self.cfg, runtime_terms=self.runtime_terms)
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
    return get_bath_dimension(cfg or get_config(), get_global_basis())


def ed_add_twobody_operator(oi, si, oj, sj, ok, sk, ol, sl, u) -> None:
    _S().add_twobody_operator(oi, si, oj, sj, ok, sk, ol, sl, u)


def ed_reset_umatrix() -> None:
    _S().reset_umatrix()


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


def _store_path(name: str) -> str:
    """<ed_output_dir>/<name><suffix>.npz of the current config."""
    cfg = get_config()
    return os.path.join(cfg.ed_output_dir, f"{name}{cfg.ed_file_suffix}.npz")


def ed_read_impgmatrix(path: Optional[str] = None):
    """Reload the Källén-Lehmann GF store written by a previous solve so
    G/Σ/D can be re-evaluated on any grid without re-solving (reference
    ed_read_ImpGMatrix -> read_GFmatrix, ED_GFMATRIX.f90:78-107)."""
    from .solver.greens import GFMatrix
    gf = GFMatrix.load(path or _store_path("gfmatrix"))
    s = _S()
    if s.result is not None:
        s.result.gf = gf
    s.loaded_gf = gf
    return gf


def ed_build_impg(zeta, axis="m"):
    return ed_get_gimp(zeta, axis, typ="n")


def ed_build_sigma(zeta, axis="m"):
    return ed_get_sigma(zeta, axis, typ="n")


ed_read_impdmatrix = ed_read_impgmatrix   # D(z) lives in the same store


def ed_build_impd(zeta, axis="m"):
    return ed_get_dimp(zeta, axis)


# -- energies, density matrices, phonons, runtime input ----------------------


def ed_get_epot():
    """⟨Hint⟩ + Hartree terms (reference ed_get_epot, get_energy.f90:18)."""
    return float(_R().energies[0])


def ed_get_eint():
    return float(_R().energies[1])


def ed_get_ehartree():
    return float(_R().energies[2])


def ed_get_eknot():
    return float(_R().energies[3])


def ed_get_ephon():
    """(Eph, Eeph) phonon energy contributions (reference ed_get_ephon)."""
    obs = _R().obs
    return np.array([obs.eph, obs.eeph])


def ed_get_phon():
    """(⟨b†b⟩, ⟨X⟩, ⟨X²⟩) (reference ed_get_phon_site)."""
    obs = _R().obs
    nvec = np.arange(len(obs.ph_n))
    return np.array([float(nvec @ obs.ph_n), obs.ph_x, obs.ph_x2])


def ed_get_nsectors() -> int:
    return len(SectorTable(get_config()))


def ed_get_sp_dm():
    return _R().single_particle_dm


def ed_get_denmat():
    """Full one-body density matrix over imp+bath levels as
    (Nspin,Nspin,Ns,Ns), spin-diagonal in the normal mode (reference
    ed_get_denmat / full_1body_density_matrix, get_denmat.f90)."""
    sp = np.asarray(_R().single_particle_dm)
    nspin, ns = sp.shape[0], sp.shape[-1]
    out = np.zeros((nspin, nspin, ns, ns), complex)
    for s in range(nspin):
        out[s, s] = sp[s]
    return out


def ed_get_imp_info():
    return _R().imp_info


def ed_set_g_ph(g) -> None:
    """Orbital-diagonal e-ph couplings (reference ed_set_G_ph)."""
    g = np.asarray(g, float)
    vals = list(np.diag(g)) if g.ndim == 2 else list(g)
    set_config(get_config().replace(g_ph=vals))
    if _solver is not None:
        _solver.cfg = _solver.cfg.replace(g_ph=vals)


def ed_set_a_ph(a: float) -> None:
    """Linear phonon displacement term (reference ed_set_A_ph)."""
    set_config(get_config().replace(a_ph=float(a)))
    if _solver is not None:
        _solver.cfg = _solver.cfg.replace(a_ph=float(a))


def ed_update_input(name: str, vals):
    """Runtime update of the whitelisted input fields (reference
    ed_update_input, ED_INPUT_VARS.f90:887-916): EXC_FIELD, PAIR_FIELD,
    SPIN_FIELD_X/Y/Z."""
    s = _S()
    cfg = s.cfg
    key = name.upper()
    vals = list(np.atleast_1d(np.asarray(vals, float)))
    sizes = {"EXC_FIELD": 4, "PAIR_FIELD": cfg.norb,
             "SPIN_FIELD_X": cfg.norb, "SPIN_FIELD_Y": cfg.norb,
             "SPIN_FIELD_Z": cfg.norb}
    if key not in sizes:
        raise ValueError("WRONG NAME ON ED_UPDATE_INPUT")
    if len(vals) != sizes[key]:
        raise ValueError(f"WRONG SIZE IN ED_UPDATE_{key}")
    field = key.lower()
    if key != "EXC_FIELD":
        cur = list(getattr(cfg, field))
        cur[:len(vals)] = vals
        vals = cur
    s.cfg = cfg.replace(**{field: vals})


# -- two-body terms from files (reference read/save_umatrix_file) ------------


def ed_read_umatrix_file(path: str) -> None:
    """Load a two-body operator list from a umatrix file into the runtime
    terms (reference read_umatrix_file, ED_PARSE_UMATRIX.f90:363+)."""
    from .umatrix import read_umatrix_file
    _S().runtime_terms = list(read_umatrix_file(path))


def ed_save_umatrix_file(path: str) -> None:
    """Save the active two-body operator list (reference save_umatrix_file)."""
    from .umatrix import save_umatrix_file
    s = _S()
    save_umatrix_file(build_umatrix(s.cfg, runtime_terms=s.runtime_terms),
                      path)


# -- susceptibilities (chi*_flag) --------------------------------------------


def ed_get_chi(kind="spin", zeta=None, axis="m"):
    return _R().get_chi(kind, zeta, axis)


def ed_get_spinchi(zeta=None, axis="m"):
    return ed_get_chi("spin", zeta, axis)


def ed_get_denschi(zeta=None, axis="m"):
    return ed_get_chi("dens", zeta, axis)


def ed_get_pairchi(zeta=None, axis="m"):
    return ed_get_chi("pair", zeta, axis)


def ed_get_exctchi(zeta=None, axis="m"):
    return ed_get_chi("exct", zeta, axis)


def ed_build_spinchi(zeta, axis="m"):
    return ed_get_chi("spin", zeta, axis)


def ed_build_denschi(zeta, axis="m"):
    return ed_get_chi("dens", zeta, axis)


def ed_build_pairchi(zeta, axis="m"):
    return ed_get_chi("pair", zeta, axis)


def ed_build_exctchi(zeta, axis="m"):
    return ed_get_chi("exct", zeta, axis)


def _read_chimatrix(path: Optional[str] = None):
    """Reload the χ weight/pole store a previous solve wrote
    (chimatrix<suffix>.npz, the layout edipack_tpu writes)."""
    from .solver.greens import GFMatrix
    chi = GFMatrix.load(path or _store_path("chimatrix"))
    s = _S()
    if s.result is not None:
        s.result.chi = chi
    s.loaded_chi = chi
    return chi


ed_read_spinchimatrix = _read_chimatrix
ed_read_denschimatrix = _read_chimatrix
ed_read_pairchimatrix = _read_chimatrix
ed_read_exctchimatrix = _read_chimatrix


# -- impurity reduced density matrix (rdm_flag) ------------------------------


def ed_get_rdm(norbs=None):
    return _R().get_rdm(norbs)


def ed_get_impurity_rdm(norbs=None):
    return ed_get_rdm(norbs)


def ed_get_reduced_rdm(orbital_mask):
    """Orbital-subset impurity RDM with fermionic sign bookkeeping
    (reference get_reduced_rdm, ED_RDM.f90:71-230)."""
    from .solver.rdm import get_reduced_rdm
    r = _R()
    return get_reduced_rdm(r.get_rdm(), orbital_mask, r.cfg.norb)


# -- Krylov complexity builders and getters (reference ED_KRYLOV,
#    ed_get_KSC/SSC/PSC/KOC/SOC/POC, ED_IO/get_krylov.f90) --------------------


def ed_build_krylov_state_complexity(ops=("cdg", "c", "g1")):
    from .solver.krylov import krylov_state_complexity
    s = _S()
    s.krylov_state = krylov_state_complexity(_R(), ops=ops)
    return s.krylov_state


def ed_build_krylov_operator_complexity(ops=("n",)):
    from .solver.krylov import krylov_operator_complexity
    s = _S()
    s.krylov_op = krylov_operator_complexity(_R(), ops=ops)
    return s.krylov_op


def _krylov_field(attr: str, field: str):
    """Pack a KrylovResult dict field into the reference array layout
    (iop, ispin, iorb, [m,] Ltimes) (reference ed_KSC/ed_PSC shapes)."""
    res = getattr(_S(), attr, None)
    if res is None:
        raise RuntimeError("build the Krylov complexity first "
                           "(ed_build_krylov_*_complexity)")
    d = getattr(res, field)
    cfg = _S().cfg
    ops = []
    for (op, _s, _o) in d:
        if op not in ops:
            ops.append(op)
    lt = len(res.times)
    if field == "distribution":
        mmax = max(v.shape[0] for v in d.values())
        out = np.zeros((len(ops), cfg.nspin, cfg.norb, mmax, lt))
        for (op, s, o), v in d.items():
            out[ops.index(op), s, o, :v.shape[0], :] = v
    else:
        out = np.zeros((len(ops), cfg.nspin, cfg.norb, lt))
        for (op, s, o), v in d.items():
            out[ops.index(op), s, o, :] = v
    return out


def ed_get_ksc():
    """Krylov state complexity K(t) (reference ed_get_KSC)."""
    return _krylov_field("krylov_state", "complexity")


def ed_get_ssc():
    """Spread state entropy S(t) (reference ed_get_SSC)."""
    return _krylov_field("krylov_state", "entropy")


def ed_get_psc():
    """Krylov-basis probabilities |φ_n(t)|² (reference ed_get_PSC)."""
    return _krylov_field("krylov_state", "distribution")


def ed_get_koc():
    return _krylov_field("krylov_op", "complexity")


def ed_get_soc():
    return _krylov_field("krylov_op", "entropy")


def ed_get_poc():
    return _krylov_field("krylov_op", "distribution")


# -- joint-mode getters: superc / nonsu2 results (ROADMAP A10) ---------------


def ed_get_quantum_soc_operators():
    raise not_implemented("ed_get_quantum_soc_operators (nonsu2)",
                          "joint modes")


def ed_get_phi():
    raise not_implemented("ed_get_phi (superc)", "joint modes")


def ed_get_argphi():
    raise not_implemented("ed_get_argphi (superc)", "joint modes")


def ed_get_exct():
    raise not_implemented("ed_get_exct", "joint modes")


def ed_build_impf(zeta, axis="m"):
    raise not_implemented("ed_build_impf (superc)", "joint modes")


def ed_build_self(zeta, axis="m"):
    raise not_implemented("ed_build_self (superc)", "joint modes")
