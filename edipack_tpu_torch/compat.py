"""Reference-ABI bridge: the Python side of the drop-in C compatibility
layer; counterpart of edipack_tpu.compat.

The reference ships iso_c_binding wrappers with a fixed C name/signature
surface (src/c_bindings/edipack_cbindings.h + edipack/edipack_c_bindings_*.f90
+ edipack2ineq/*.f90). ``edipack_tpu_torch/capi/edipack_compat.c`` exports
the same symbols and wraps the raw buffers as numpy arrays without a copy
(``np.frombuffer``); every function here receives those arrays, reshapes
them in Fortran (column-major) order — the reference ABI's memory layout —,
runs edipack_tpu_torch on the library's device (capihelp.DEVICE, from
EDIPACK_TPU_TORCH_DEVICE), and writes results in place into the caller's
buffers.

Shape contracts (verified against the reference .f90 binding sources):
  - statics are real(c_double): dens(Norb), docc(Norb), mag(3,Norb),
    phisc/argsc(Norb,Norb), eimp(4), phon(3), ephon(2)
    (edipack_c_bindings_io.f90:6-55,396-408)
  - GF/Sigma site n3 = (Nspin*Norb, Nspin*Norb, L), n5 =
    (Nspin,Nspin,Norb,Norb,L); lattice n3 = (Nlat*Nso, Nlat*Nso, L)
    block-diagonal, n4 = (Nlat,Nso,Nso,L), n6 = (Nlat,Nspin,Nspin,Norb,Norb,L)
    (edipack_c_bindings_io.f90:57-98, edipack2ineq_c_bindings_io.f90:60-94)
  - axis 0="m" 1="r" (2="t" for chi); typ 0="n" 1="a"
  - lattice bath arrays are (Nlat, Nb) Fortran-order
    (edipack2ineq_c_bindings_main.f90:2-30)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import capihelp as H
from . import main as M
from .config import ed_read_input, get_config, update_config

# C global name -> config field (reference exports these as bind(c) module
# variables, edipack_cbindings.h:14-60; drivers read AND write them).
GLOBALS = {
    "beta": "beta", "dmft_error": "dmft_error", "eps": "eps",
    "Jh": "jh", "Jp": "jp", "Jx": "jx", "nread": "nread",
    "sb_field": "sb_field", "Ust": "ust", "wfin": "wfin", "wini": "wini",
    "xmax": "xmax", "xmin": "xmin", "xmu": "xmu",
    "Lfit": "lfit", "Lmats": "lmats", "Lreal": "lreal", "Lpos": "lpos",
    "Ltau": "ltau", "Nbath": "nbath", "Nloop": "nloop", "Norb": "norb",
    "Nph": "nph", "Nspin": "nspin", "Nsuccess": "nsuccess",
    "chidens_flag": "chidens_flag", "chiexct_flag": "chiexct_flag",
    "chipair_flag": "chipair_flag", "chispin_flag": "chispin_flag",
    "ed_twin": "ed_twin", "ed_total_ud": "ed_total_ud",
    "rdm_flag": "rdm_flag",
}


def get_globals() -> dict:
    cfg = get_config()
    out = {k: getattr(cfg, f) for k, f in GLOBALS.items()}
    u = list(cfg.uloc) + [0.0] * 5
    out["Uloc"] = u[:5]
    return out


def set_globals(changed: dict) -> None:
    kw = {}
    for k, v in changed.items():
        if k == "Uloc":
            kw["uloc"] = [float(x) for x in v][: get_config().norb]
        elif k in GLOBALS:
            f = GLOBALS[k]
            cur = getattr(get_config(), f)
            kw[f] = type(cur)(v) if not isinstance(cur, bool) else bool(v)
    if kw:
        update_config(**kw)


def frombuffer(buf, dtype: str) -> np.ndarray:
    """The C side's buffer (a memoryview of the caller's memory) as a 1-D
    array of ``dtype``, without a copy."""
    return np.frombuffer(buf, dtype)


def read_input(path: str) -> None:
    ed_read_input(path)


# -- Hloc -------------------------------------------------------------------

def _fshape(flat: np.ndarray, dims) -> np.ndarray:
    return np.asarray(flat).reshape(tuple(int(d) for d in dims), order="F")


def set_hloc_single(h: np.ndarray, ha: Optional[np.ndarray], dims) -> None:
    """ed_set_Hloc_single_N2/N4 (edipack_c_bindings_aux_funx.f90:1-31)."""
    cfg = get_config()
    hm = _fshape(h, dims)
    if len(dims) == 4:
        hm = hm.transpose(0, 2, 1, 3).reshape(
            cfg.nspin * cfg.norb, cfg.nspin * cfg.norb)
    am = None
    if cfg.ed_mode == "superc" and ha is not None:
        am = _fshape(ha, dims)
        if len(dims) == 4:
            am = am.transpose(0, 2, 1, 3).reshape(hm.shape)
    M.ed_set_hloc(hm, am)


def set_hloc_lattice(h: np.ndarray, ha: Optional[np.ndarray], dims,
                     nlat: int) -> None:
    """ed_set_Hloc_lattice_N2/N3/N5 (edipack2ineq_c_bindings_aux_funx.f90)."""
    cfg = get_config()
    nso = cfg.nspin * cfg.norb
    hm = _fshape(h, dims)
    if len(dims) == 2:  # (Nlat*Nso, Nlat*Nso) block-diagonal
        per = np.stack([hm[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso]
                        for i in range(nlat)])
    elif len(dims) == 3:  # (Nlat, Nso, Nso)
        per = hm
    else:  # (Nlat, Nspin, Nspin, Norb, Norb)
        per = hm.transpose(0, 1, 3, 2, 4).reshape(nlat, nso, nso)
    H.ineq_init(nlat)
    H._ineq.set_hloc(per)


# -- scalar/bath helpers ----------------------------------------------------

def bath_dimension_direct() -> int:
    return int(M.ed_get_bath_dimension())


def bath_dimension_symmetries(nsym: int) -> int:
    """get_bath_dimension_symmetries: replica/general bath with Nsym basis
    matrices (reference ED_BATH_DIM.f90 get_bath_dimension_symmetries)."""
    cfg = get_config()
    nb = cfg.nbath
    if cfg.bath_type == "general":
        return nb * nsym + nb * cfg.nspin * cfg.norb
    return nb * nsym + nb


def search_variable(var: float, ntmp: float):
    newvar, conv = M.ed_search_variable(float(var), float(ntmp), False)
    return float(newvar), int(bool(conv))


def set_a_ph(a: np.ndarray) -> None:
    M.ed_set_a_ph(float(np.asarray(a).ravel()[0]))


def set_g_ph(g: np.ndarray) -> None:
    cfg = get_config()
    M.ed_set_g_ph(_fshape(g, (cfg.norb, cfg.norb)))


def init_hbasis(kind: str, hvec: np.ndarray, d_hvec, lam: np.ndarray,
                d_lam) -> None:
    """init_Hreplica/Hgeneral_symmetries_d3/d5 (+_lattice variants).

    d3: Hvec (Nso,Nso,Nsym), d5: (Nspin,Nspin,Norb,Norb,Nsym); lambdavec
    (Nbath,Nsym) or lattice (Nlat,Nbath,Nsym)
    (edipack_c_bindings_bath.f90 init_Hreplica_*)."""
    cfg = get_config()
    nso = cfg.nspin * cfg.norb
    hv = _fshape(hvec, d_hvec)
    nsym = int(d_hvec[-1])
    if len(d_hvec) == 3:
        ops = np.transpose(hv, (2, 0, 1)).reshape(
            nsym, cfg.nspin, cfg.norb, cfg.nspin, cfg.norb
        ).transpose(0, 1, 3, 2, 4)
    else:
        ops = np.transpose(hv, (4, 0, 1, 2, 3))
    lm = _fshape(lam, d_lam)
    from .bath.user import ed_set_hgeneral, ed_set_hreplica
    setter = ed_set_hreplica if kind == "replica" else ed_set_hgeneral
    if len(d_lam) == 3:  # lattice: (Nlat, Nbath, Nsym)
        global _lattice_lambdas
        _lattice_lambdas = (kind, ops, np.array(lm))
        setter(ops, np.array(lm[0]), nbath=int(d_lam[1]))
    else:
        setter(ops, np.array(lm), nbath=int(d_lam[0]))
    _ = nso


_lattice_lambdas = None


# -- bath symmetry ops ------------------------------------------------------
# name is the user-module function name (ed_break_symmetry_bath, ...) whose
# first arg is the packed bath array (bath/user.py conventions).

def bath_op_site(name: str, bath: np.ndarray, *args) -> None:
    from .bath import user as U
    fn = getattr(U, name)
    new = np.asarray(fn(np.array(bath, float), *args))
    bath[: new.size] = new.ravel()


def bath_op_ineq(name: str, bath: np.ndarray, dims, *args) -> None:
    """_ineq bath ops: per-site over the (Nlat, Nb) Fortran-order array;
    break_symmetry takes a per-site sign vector
    (edipack_cbindings.h:631-646)."""
    from .bath import user as U
    fn = getattr(U, name)
    b2 = _fshape(bath, dims).copy()  # (Nlat, Nb)
    for i in range(b2.shape[0]):
        a = args
        if name == "ed_break_symmetry_bath" and \
                isinstance(args[1], np.ndarray):
            a = (args[0], float(np.asarray(args[1]).ravel()[i]), *args[2:])
        b2[i] = np.asarray(fn(b2[i].copy(), *a)).ravel()
    bath[:] = b2.ravel(order="F")


# -- chi2 fits --------------------------------------------------------------

def _site_target(g: np.ndarray, dims, cfg):
    """The caller's (read-only) buffer as a fit target: a writable copy in
    (Nspin,Nspin,Norb,Norb,L)."""
    gm = _fshape(g, dims)
    if len(dims) == 3:  # (Nso,Nso,L) -> (Nspin,Nspin,Norb,Norb,L)
        no, L = cfg.norb, int(dims[-1])
        gm = gm.reshape(cfg.nspin, no, cfg.nspin, no, L).transpose(
            0, 2, 1, 3, 4)
    return np.array(gm)


def fit_single(g: np.ndarray, dim_g, f: Optional[np.ndarray], dim_f,
               bath: np.ndarray, ispin: int, iorb: int) -> None:
    """chi2_fitgf_single_normal/superc_n3/n5
    (edipack_c_bindings_bath_fit.f90)."""
    cfg = get_config()
    gm = _site_target(g, dim_g, cfg)
    func = gm if f is None else (gm, _site_target(f, dim_f, cfg))
    new = M.ed_chi2_fitgf(func, np.array(bath, float), ispin=ispin,
                          iorb=(iorb if iorb and iorb > 0 else None))
    bath[: np.asarray(new).size] = np.asarray(new).ravel()


def fit_lattice(g: np.ndarray, dim_g, f: Optional[np.ndarray], dim_f,
                bath: np.ndarray, dim_bath, ispin: int) -> None:
    """chi2_fitgf_lattice_* — per-site fit over the (Nlat,Nb) bath
    (edipack2ineq_c_bindings_bath_fit.f90)."""
    cfg = get_config()
    nso = cfg.nspin * cfg.norb
    nlat = int(dim_bath[0])
    gm = _fshape(g, dim_g)
    fm = _fshape(f, dim_f) if f is not None else None

    def site(arr, i):
        if arr is None:
            return None
        if arr.ndim == 3:  # (Nlat*Nso, Nso, L) stacked per site
            return _site_target(
                arr[i * nso:(i + 1) * nso].ravel(order="F"),
                (nso, nso, arr.shape[-1]), cfg)
        if arr.ndim == 4:  # (Nlat, Nso, Nso, L)
            return _site_target(arr[i].ravel(order="F"),
                                (nso, nso, arr.shape[-1]), cfg)
        return arr[i]  # (Nlat,Nspin,Nspin,Norb,Norb,L)

    b2 = _fshape(bath, dim_bath).copy()
    from .bath.fit import chi2_fitgf
    for i in range(nlat):
        gi, fi = site(gm, i), site(fm, i)
        func = gi if fi is None else (gi, fi)
        b2[i] = np.asarray(chi2_fitgf(cfg, func, b2[i].copy(),
                                      ispin=ispin)).ravel()
    bath[:] = b2.ravel(order="F")


# -- statics ----------------------------------------------------------------

def static_site(name: str, out: np.ndarray) -> None:
    cfg = get_config()
    if name == "mag":  # (3,Norb) F-order
        m = np.stack([np.asarray(M.ed_get_mag(c)) for c in "xyz"])
        out[:] = m.ravel(order="F")
    elif name in ("phisc", "argsc"):
        v = np.asarray(M.ed_get_phi() if name == "phisc"
                       else M.ed_get_argphi())
        if v.ndim < 2:
            v = np.diag(np.atleast_1d(v)) if v.size == cfg.norb else \
                v.reshape(cfg.norb, cfg.norb)
        out[:] = v.ravel(order="F")
    else:
        fn = {"dens": M.ed_get_dens, "docc": M.ed_get_docc,
              "eimp": M.ed_get_eimp, "phon": M.ed_get_phon,
              "ephon": M.ed_get_ephon}[name]
        v = np.asarray(fn()).ravel()
        out[: v.size] = v


def static_lattice(name: str, out: np.ndarray, nlat: int) -> None:
    if name == "mag":
        m = np.stack([np.asarray(H.ineq_get("mag", c)) for c in "xyz"],
                     axis=1)  # (Nlat,3,Norb)
        out[:] = m.ravel(order="F")
        return
    key = {"phisc": "phi", "argsc": "argphi"}.get(name, name)
    v = np.asarray(H.ineq_get(key))
    cfg = get_config()
    if name in ("phisc", "argsc") and v.ndim < 3:
        v = np.stack([np.diag(np.atleast_1d(x)) if np.atleast_1d(x).size ==
                      cfg.norb else x.reshape(cfg.norb, cfg.norb) for x in v])
    out[:] = v.ravel(order="F")


# -- dynamical functions ----------------------------------------------------

_AXIS = {0: "m", 1: "r", 2: "t"}


def _zeta(zeta: Optional[np.ndarray], zflag: int):
    return np.asarray(zeta) if (zflag and zeta is not None) else None


def gf_site(which: str, out: np.ndarray, axis: int, typ: int,
            zeta, dz: int, zflag: int, rank: int) -> None:
    """get_sigma/gimp_site_n3/n5, get_dimp_site_n1."""
    cfg = get_config()
    fn = {"sigma": M.ed_get_sigma, "gimp": M.ed_get_gimp,
          "g0imp": M.ed_get_g0imp}[which] if which != "dimp" else None
    z = _zeta(zeta, zflag)
    if which == "dimp":
        v = np.asarray(M.ed_get_dimp(z, _AXIS[axis]))
        out[: v.size] = v.ravel()
        return
    v = np.asarray(fn(z, _AXIS[axis], "a" if typ == 1 else "n"))
    if rank == 3:
        nso = cfg.nspin * cfg.norb
        v = v.transpose(0, 2, 1, 3, 4).reshape(nso, nso, -1)
    out[:] = v.ravel(order="F")


def gf_lattice(which: str, out: np.ndarray, nineq: int, axis: int, typ: int,
               zeta, dz: int, zflag: int, rank: int) -> None:
    """get_sigma/gimp_lattice_n3/n4/n6 (edipack2ineq_c_bindings_io.f90)."""
    cfg = get_config()
    nso = cfg.nspin * cfg.norb
    z = _zeta(zeta, zflag)
    name = {"sigma": "sigma", "gimp": "gimp", "dimp": "dimp"}[which]
    if which == "dimp":
        v = np.asarray(H.ineq_get(name, z, _AXIS[axis]))  # (Nlat, L)
        out[:] = v.ravel(order="F")
        return
    v = np.asarray(H.ineq_get(name, z, _AXIS[axis],
                              "a" if typ == 1 else "n"))
    # v: (Nlat,Nspin,Nspin,Norb,Norb,L)
    L = v.shape[-1]
    if rank == 6:
        out[:] = v.ravel(order="F")
    elif rank == 4:
        vs = v.transpose(0, 1, 3, 2, 4, 5).reshape(nineq, nso, nso, L)
        out[:] = vs.ravel(order="F")
    else:  # rank 3: (Nlat*Nso, Nlat*Nso, L) block-diagonal embedding
        big = np.zeros((nineq * nso, nineq * nso, L), complex)
        vs = v.transpose(0, 1, 3, 2, 4, 5).reshape(nineq, nso, nso, L)
        for i in range(nineq):
            big[i * nso:(i + 1) * nso, i * nso:(i + 1) * nso] = vs[i]
        out[:] = big.ravel(order="F")


def g0and_delta(which: str, warray: np.ndarray, bath: np.ndarray,
                out: np.ndarray, dims_out, axis: str, typ: str) -> None:
    """get_g0and_n3/n5, get_delta_n3/n5 (edipack_c_bindings_io.f90)."""
    cfg = get_config()
    fn = M.ed_get_g0and if which == "g0and" else M.ed_get_delta
    v = np.asarray(fn(np.asarray(warray), np.array(bath, float),
                      axis=axis or "m", typ=typ or "n"))
    if len(dims_out) == 3:
        nso = cfg.nspin * cfg.norb
        v = v.transpose(0, 2, 1, 3, 4).reshape(nso, nso, -1)
    out[:] = v.ravel(order="F")


def chi_compat(kind: str, out: np.ndarray, zeta, dz: int, zflag: int,
               axis: str, nsites: int, latticeflag: int) -> None:
    """ed_get_spinchi/denschi/pairchi/exctchi: out (Nsites,Norb,Norb,L)
    Fortran-order (edipack_c_bindings_io.f90:209-239)."""
    z = _zeta(zeta, zflag)
    if latticeflag and nsites > 1:
        v = np.asarray(H.ineq_get("chi", kind, z, axis or "m"))
    else:
        v = np.asarray(M.ed_get_chi(kind, z, axis or "m"))[None]
    out[:] = v.ravel(order="F")


def rdm_compat(out: np.ndarray, doprint: int) -> None:
    v = np.asarray(M.ed_get_rdm())
    out[:] = v.ravel(order="F")
    if doprint:
        np.savetxt("reduced_density_matrix.ed",
                   np.column_stack([v.real.ravel(), v.imag.ravel()]))


def denmat_compat(out: np.ndarray, dims, doprint: int) -> None:
    """ed_get_denmat_n2/n4: one-body density matrix, n2 = (Nspin*Ns, Nspin*Ns)
    spin-blocked, n4 = (Nspin,Nspin,Ns,Ns) (edipack_c_bindings_io.f90
    get_denmat_n2_c/get_denmat_n4_c)."""
    v = np.asarray(M.ed_get_denmat())  # (Nspin,Nspin,Ns,Ns)
    nspin, ns = v.shape[0], v.shape[-1]
    if len(dims) == 2:
        n1 = int(dims[0])
        big = np.zeros((nspin * ns, nspin * ns), complex)
        for s1 in range(nspin):
            for s2 in range(nspin):
                big[s1 * ns:(s1 + 1) * ns, s2 * ns:(s2 + 1) * ns] = v[s1, s2]
        out[:] = big[:n1, :n1].ravel(order="F")
    else:
        out[:] = v[:int(dims[0]), :int(dims[1]), :int(dims[2]),
                   :int(dims[3])].ravel(order="F")
    if doprint:
        flat = v.ravel()
        np.savetxt("single_particle_density_matrix.ed",
                   np.column_stack([flat.real, flat.imag]))


# -- lifecycle --------------------------------------------------------------

def init_solver_site(bath: np.ndarray) -> None:
    new = np.asarray(M.ed_init_solver(device=H.DEVICE))
    bath[: new.size] = new.ravel()


def init_solver_site_nobath() -> None:
    update_config(nbath=0)
    M.ed_init_solver(device=H.DEVICE)


def solve_site(bath: np.ndarray, flag_gf: int) -> None:
    M.ed_solve(np.array(bath, float), flag_gf=bool(flag_gf))


def solve_site_nobath(flag_gf: int) -> None:
    M.ed_solve(None, flag_gf=bool(flag_gf))


def init_solver_ineq(bath: np.ndarray, dims) -> None:
    nlat = int(dims[0])
    if H._ineq is None or H._ineq.nineq != nlat:
        H.ineq_init(nlat)
    if _lattice_lambdas is not None:
        # per-site replica/general lambdas (init_H*_symmetries_lattice_d*):
        # set the global basis before each site's init so every solver binds
        # its own lambda matrix (EDSolver.init_solver re-reads the basis).
        kind, ops, lams = _lattice_lambdas
        from .bath.user import ed_set_hgeneral, ed_set_hreplica
        setter = ed_set_hreplica if kind == "replica" else ed_set_hgeneral
        out = []
        for i, s in enumerate(H._ineq.solvers):
            setter(ops, lams[i], nbath=lams.shape[1])
            out.append(s.init_solver(None))
        bath[:] = np.stack(out).ravel(order="F")
        return
    new = H._ineq.init_solver()
    bath[:] = np.asarray(new).ravel(order="F")


def init_solver_ineq_nobath(nlat: int) -> None:
    update_config(nbath=0)
    H.ineq_init(int(nlat))
    H._ineq.init_solver()


def solve_ineq(bath: np.ndarray, dims, flag_gf: int) -> None:
    b2 = _fshape(bath, dims)
    H._ineq.solve(np.array(b2), flag_gf=bool(flag_gf))


def solve_ineq_nobath(nlat: int, flag_gf: int) -> None:
    H._ineq.solve(None, flag_gf=bool(flag_gf))


def finalize_solver(nineq: int) -> None:
    if nineq > 0 and H._ineq is not None:
        H._ineq.finalize()
        H._ineq = None
    else:
        M.ed_finalize_solver()
    H.finalize_library()
