"""The superc / nonsu2 cases of the joint golden (tests/gen_torch_golden.py
joint, tests/data/torch_port_golden_joint.json), and one driver that runs
a case through the ``ed_*`` API of either package.

``run_case(pkg, case)`` takes ``pkg``, the package's modules as
:func:`modules` returns them, so the same code drives edipack_tpu (the
generator) and edipack_tpu_torch (tests/test_torch_joint_api.py and
chip_smoke.py, on the card). This module imports neither package nor jax.
Not collected by pytest (the file name does not start with ``test_``).
"""
import importlib
from types import SimpleNamespace

import numpy as np

NMATS = 32
WBAND = 1.0               # Bethe-lattice half-bandwidth of the fit targets
FIT = dict(cg_scheme="delta", cg_method=1)   # L-BFGS-B: reproducible


def _soc_hloc(lam: float) -> np.ndarray:
    """λ L·S on the t2g triplet (l=1; basis yz, zx, xy), (2, 2, 3, 3)."""
    lx = np.array([[0, 0, 0], [0, 0, -1j], [0, 1j, 0]])
    ly = np.array([[0, 0, 1j], [0, 0, 0], [-1j, 0, 0]])
    lz = np.array([[0, -1j, 0], [1j, 0, 0], [0, 0, 0]])
    h = np.zeros((2, 2, 3, 3), complex)
    h[0, 0], h[1, 1] = 0.5 * lz, -0.5 * lz
    h[0, 1] = 0.5 * (lx - 1j * ly)
    h[1, 0] = 0.5 * (lx + 1j * ly)
    return lam * h


def _spin_mixing_hloc(norb: int, amp: float) -> np.ndarray:
    """bench.py's SOC-like spin-mixing Hloc of BASELINE config 4."""
    h = np.zeros((2, 2, norb, norb), complex)
    h[0, 1] = 1j * amp * np.eye(norb)
    h[1, 0] = -1j * amp * np.eye(norb)
    return h


def _nambu_basis() -> dict:
    """tests/test_fit_joint.py's superc replica basis at norb=2: (h, -hᵀ),
    same-orbital and cross pairing."""
    o1 = np.zeros((2, 2, 2, 2), complex)
    o1[0, 0] = np.diag([1.0, -1.0])
    o1[1, 1] = -o1[0, 0].T
    o2 = np.zeros((2, 2, 2, 2), complex)
    o2[0, 1] = o2[1, 0] = np.eye(2)
    o3 = np.zeros((2, 2, 2, 2), complex)
    o3[0, 1] = o3[1, 0] = np.array([[0, 1], [1, 0]])
    return dict(ops=np.stack([o1, o2, o3]),
                lam=np.array([[0.5, 0.2, 0.1], [-0.4, 0.15, 0.05]]))


SUPERC = dict(ed_mode="superc", uloc=[-2.0, -2.0], ust=-1.0, jh=0.25,
              jx=0.25, jp=0.25, deltasc=0.02)          # bench.py config 3
NONSU2 = dict(ed_mode="nonsu2", nspin=2, uloc=[2.0, 2.0], ust=1.2, jh=0.25,
              spin_field_x=[0.1, 0.1])                 # bench.py config 4

CASES = {
    # superc at norb=2, nbath=3 (Sz=0 dim 12,870: Lanczos sectors), with a
    # crystal field and an anomalous Hloc; fitted to (D/2)² (G, F) after
    "superc": dict(
        config=dict(norb=2, nbath=3, **SUPERC),
        hloc=np.diag([0.1, -0.1])[None, None].astype(complex),
        hloc_anomalous=np.array([[0.05, 0.02], [0.02, -0.03]], complex),
        fit=True),
    # nonsu2 at norb=2, nbath=2 with the spin-mixing Hloc and spin_field_x;
    # sectors above 256 states through Lanczos; fitted to (D/2)² G after
    "nonsu2": dict(
        config=dict(norb=2, nbath=2, lanc_dim_threshold=256, **NONSU2),
        hloc=_spin_mixing_hloc(2, 0.1), fit=True),
    # the t2g model with λ L·S and the quantum SOC operators
    "soc": dict(
        config=dict(norb=3, nbath=1, nspin=2, ed_mode="nonsu2",
                    bath_type="replica", uloc=[1.0] * 3, ust=0.4, jh=0.1,
                    jx=0.05, lanc_dim_threshold=256),
        hloc=_soc_hloc(0.3),
        basis=dict(ops=np.eye(6)[None], lam=np.array([[-0.7]]))),
    # a complex Hloc in ed_mode=normal: solved through nonsu2
    "cplx_normal": dict(
        config=dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=1.2,
                    jh=0.2, lanc_dim_threshold=256),
        hloc=np.array([[[[0.1, 0.1j], [-0.1j, -0.1]]]])),
    # a replica bath in superc (Nambu basis)
    "replica_superc": dict(
        config=dict(norb=2, nbath=2, bath_type="replica",
                    lanc_dim_threshold=256, **SUPERC),
        hloc=np.zeros((1, 1, 2, 2), complex), basis=_nambu_basis()),
    # a joint solve with phonons (tests/test_joint_phonon.py's model)
    "phonon": dict(
        config=dict(norb=1, nbath=2, nspin=1, ed_mode="superc",
                    uloc=[-1.5], deltasc=0.12, xmu=0.1, beta=80.0, nph=3,
                    g_ph=[0.3], w0_ph=0.7, lanc_dim_threshold=16),
        hloc=np.zeros((1, 1, 1, 1), complex)),
}


def modules(name: str) -> SimpleNamespace:
    """The modules run_case drives, of package ``name`` (edipack_tpu or
    edipack_tpu_torch)."""
    config = importlib.import_module(name + ".config")
    return SimpleNamespace(
        main=importlib.import_module(name + ".main"),
        user=importlib.import_module(name + ".bath.user"),
        default_config=config.default_config, set_config=config.set_config,
        get_config=config.get_config, torch=name.endswith("torch"))


def _z(beta: float) -> np.ndarray:
    return 1j * np.pi / beta * (2 * np.arange(NMATS) + 1)


def run_case(pkg: SimpleNamespace, case: dict, device=None, **route) -> dict:
    """One ed_solve of ``case`` (and its fit) through the ed_* API of
    ``pkg``; ``route``: extra config fields (ed_sparse_h, ed_joint_kron).
    Returns numpy results."""
    ed = pkg.main
    cfg = pkg.default_config(**case["config"], ed_verbose=0, **FIT, **route)
    prev = pkg.get_config()
    pkg.set_config(cfg)
    try:
        if "basis" in case:
            pkg.user.ed_set_hreplica(case["basis"]["ops"],
                                     case["basis"]["lam"])
        init = dict(device=device) if pkg.torch else {}
        bath = ed.ed_init_solver(cfg=cfg, **init)
        ed.ed_set_hloc(case["hloc"], case.get("hloc_anomalous"))
        res = ed.ed_solve(bath)
        z = _z(cfg.beta)
        out = dict(e0=float(res.e0), evals=np.asarray(ed.ed_get_evals()),
                   dens=np.asarray(ed.ed_get_dens()),
                   docc=np.asarray(ed.ed_get_docc()),
                   energies=np.asarray(ed.ed_get_eimp()),
                   gimp=ed.ed_get_gimp(z), sigma=ed.ed_get_sigma(z),
                   bath=np.asarray(bath))
        mode = cfg.ed_mode
        if mode == "superc":
            out.update(impf=ed.ed_build_impf(z), self=ed.ed_build_self(z),
                       phi=np.asarray(ed.ed_get_phi()),
                       argphi=np.asarray(ed.ed_get_argphi()))
        if mode == "nonsu2":
            out.update(exct=np.asarray(ed.ed_get_exct()),
                       mag=np.stack([ed.ed_get_mag(c) for c in "xyz"]))
        if mode == "nonsu2" and cfg.norb == 3:
            soc = ed.ed_get_quantum_soc_operators()
            out.update(soc=np.concatenate([[soc.ls_imp], soc.j_imp,
                                           soc.j_imp_sq]))
        if cfg.nph > 0:
            out.update(dimp=ed.ed_get_dimp(z), phon=ed.ed_get_phon())
        if case.get("fit"):
            t2 = (WBAND / 2.0) ** 2
            target = t2 * (np.stack([out["gimp"][0, 0], out["impf"][0, 0]])
                           if mode == "superc" else out["gimp"])
            out["fit"] = np.asarray(ed.ed_chi2_fitgf(target, bath))
        ed.ed_finalize_solver()
    finally:
        pkg.user.clear_global_basis()
        pkg.set_config(prev)
    return out


# the golden's tolerances: e0 and levels 1e-10; dens, docc, φ, energies,
# G, F, Σ and the other observables 1e-8 (f64 on both sides); the fitted
# baths 1e-7, as the DMFT golden's; the input bath exactly
TOL = dict(e0=1e-10, evals=1e-10, dens=1e-8, docc=1e-8, energies=1e-8,
           gimp=1e-8, sigma=1e-8, impf=1e-8, self=1e-8, phi=1e-8,
           argphi=1e-8, exct=1e-8, mag=1e-8, soc=1e-8, dimp=1e-8,
           phon=1e-8, doubles=1e-8, bath=0.0, fit=1e-7)


def to_json(out: dict) -> dict:
    """numpy results -> JSON (complex arrays as [re, im] pairs)."""
    js = {}
    for k, v in out.items():
        a = np.asarray(v)
        js[k] = (np.stack([a.real, a.imag], -1).tolist()
                 if np.iscomplexobj(a) else a.tolist())
    return js


def from_json(js: dict, like: dict) -> dict:
    """JSON -> numpy results, complex where ``like`` (a run_case result)
    is complex."""
    out = {}
    for k, v in js.items():
        a = np.asarray(v)
        if k in like and np.iscomplexobj(like[k]):
            a = a[..., 0] + 1j * a[..., 1]
        out[k] = a
    return out


def deviations(got: dict, want: dict) -> dict:
    """Max |got - want| per key of ``want`` (a missing key: inf)."""
    dev = {}
    for k, w in want.items():
        if k not in got or np.shape(got[k]) != np.shape(w):
            dev[k] = float("inf")
            continue
        d = np.asarray(got[k]) - np.asarray(w)
        if k == "argphi":
            # a phase: ±π are one angle (arctan2 of a real negative φ
            # takes the sign of a rounding-level imaginary part)
            d = np.angle(np.exp(1j * d))
        dev[k] = float(np.max(np.abs(d), initial=0.0))
    return dev


def summary(res, z) -> dict:
    """The results of a SolveResult of either package (solver.core
    level) on the frequencies ``z``, as numpy."""
    out = dict(e0=float(res.e0), evals=np.sort(np.asarray(res.evals)),
               dens=np.asarray(res.dens), docc=np.asarray(res.docc),
               energies=np.asarray(res.energies), mag=np.asarray(res.mag),
               doubles=np.asarray(res.doubles), gimp=res.get_gimp(z),
               sigma=res.get_sigma(z))
    if res.cfg.ed_mode == "superc":
        out.update(impf=res.get_gimp(z, typ="a"),
                   self=res.get_sigma(z, typ="a"),
                   phi=np.asarray(res.phisc), argphi=np.asarray(res.argphi))
    if res.cfg.ed_mode == "nonsu2":
        out.update(exct=np.asarray(res.exct))
    if res.cfg.nph > 0:
        out.update(dimp=res.get_dimp(z))
    return out
