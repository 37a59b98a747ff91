"""The C library of edipack_tpu_torch (edipack_tpu_torch/capi) on the CPU:
built once from the repository's sources (capi/build.py), it runs the
drivers of capi/drivers/ with EDIPACK_TPU_TORCH_DEVICE=cpu (the edtpu_*
single-site and lattice drivers, and the reference-ABI single-site and
lattice drivers), whose printed numbers are held to edipack_tpu's Python
API in this process (e0 1e-10; dens, docc, energies, G 1e-8; the fitted
bath 1e-7). A bad device value, and cuda without CUDA, fail edtpu_init
with their message. Skips only where gcc or Python.h is absent; a failed
build fails."""
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.config import default_config as j_config
from edipack_tpu.config import set_config as j_set_config
from edipack_tpu.ineq import EDIneqSolver as JIneq

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(e0=1e-10, obs=1e-8, gimp=1e-8, bath=1e-7)
DRIVERS = ("edtpu_site", "edtpu_lattice", "compat_site", "compat_lattice")
# the drivers' configurations: input files for the library, the same values
# for edipack_tpu (which takes its default matvec route, not B1's)
SITE = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
            jx=0.15, jp=0.15, xmu=0.3, beta=40.0, lmats=16,
            lanc_dim_threshold=350)
LATTICE = dict(norb=1, nbath=3, nspin=1, uloc=[2.0], xmu=1.0, beta=50.0,
               lmats=16, lfit=16, cg_method=1, cg_scheme="delta")
PORT_ONLY = dict(ed_fused_matvec="always")
NLAT, HSTAG = 2, 0.2

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or not os.path.exists(
        os.path.join(sysconfig.get_paths()["include"], "Python.h")),
    reason="the C library needs gcc and Python.h")


def _input(path, config):
    with open(path, "w") as fh:
        for k, v in {**config, **PORT_ONLY, "ed_verbose": 0}.items():
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            fh.write(f"{k.upper()}={v}\n")
    return str(path)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The library (a build error fails here) and the four drivers."""
    from edipack_tpu_torch.capi import build
    lib = build.build()
    assert lib.name == "libedipack_tpu_torch_c.so"
    assert lib.parent.parent == build.BUILD_DIR
    assert build.build() == lib          # built once
    out = tmp_path_factory.mktemp("capi")
    exes = {}
    for name in DRIVERS:
        exe = out / name
        r = subprocess.run(
            ["gcc", "-O2", "-Wall", *build.include_flags(), "-o", str(exe),
             os.path.join(build.CAPI_DIR, "drivers", name + ".c"),
             *build.link_flags(lib)], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        exes[name] = str(exe)
    inputs = dict(site=_input(out / "site.in", SITE),
                  lattice=_input(out / "lattice.in", LATTICE))
    return exes, inputs, out


def _run(built, name, *args, device="cpu", ok=True):
    exes, _, cwd = built
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDIPACK_TPU_TORCH_DEVICE=device)
    out = subprocess.run([exes[name], *map(str, args)], capture_output=True,
                         text=True, env=env, cwd=str(cwd), timeout=300)
    if not ok:
        return out
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Traceback" not in out.stderr, out.stderr[-3000:]
    vals = {}
    for line in out.stdout.splitlines():
        name, n, *rest = line.split()
        assert len(rest) == int(n), line[:80]
        vals[name] = np.array([float(x) for x in rest])
    return vals


def _pairs(v, shape, order="C"):
    return (v[0::2] + 1j * v[1::2]).reshape(shape, order=order)


def _close(got, want, tol, what):
    dev = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert dev <= tol, f"{what}: {dev:.3e} > {tol}"


@pytest.fixture
def jax_cpu(tmp_path, monkeypatch):
    """edipack_tpu in tmp_path on one device."""
    import jax
    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.chdir(tmp_path)
    yield
    jed.ed_finalize_solver()


def test_edtpu_site_driver(built, jax_cpu):
    """edtpu_* single site (statics-only solve, then the full one, B1's
    plain version for the Lanczos sector) against ed_solve."""
    got = _run(built, "edtpu_site", built[1]["site"], 1, 2, SITE["lmats"])
    cfg = j_set_config(j_config(**SITE, ed_verbose=0))
    jed.ed_init_solver(cfg=cfg)
    jed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    res = jed.ed_solve()
    _close(np.sort(got["EVALS"]), np.sort(jed.ed_get_evals()), TOL["e0"],
           "evals")
    _close(got["EVALS"].min(), res.e0, TOL["e0"], "e0")
    for key, want in (("DENS", jed.ed_get_dens()), ("DOCC", jed.ed_get_docc()),
                      ("MAGZ", jed.ed_get_mag("z")),
                      ("EIMP", jed.ed_get_eimp())):
        _close(got[key], want, TOL["obs"], key)
    g = _pairs(got["G"], (1, 1, 2, 2, SITE["lmats"]))
    _close(g, jed.ed_get_gimp(), TOL["gimp"], "G")


def _jax_lattice(config):
    cfg = j_set_config(j_config(**config, ed_verbose=0))
    solver = JIneq(NLAT, cfg)
    baths = solver.init_solver()
    no = cfg.norb
    h = np.zeros((NLAT, no, no))
    for s in range(NLAT):
        h[s] = np.eye(no) * 0.5 * (2 * s - NLAT + 1) * HSTAG
    solver.set_hloc(h)
    solver.solve(baths)
    return solver


@pytest.mark.parametrize("name", ["edtpu_lattice", "compat_lattice"])
def test_lattice_drivers(built, jax_cpu, name):
    """Two sites with a staggered Hloc through edtpu_ineq_* and through
    the reference ABI's lattice functions, against EDIneqSolver."""
    no, lm = LATTICE["norb"], LATTICE["lmats"]
    if name == "edtpu_lattice":
        got = _run(built, name, built[1]["lattice"], 1, no, lm, NLAT, HSTAG)
        order = "C"
    else:
        got = _run(built, name, built[1]["lattice"], NLAT, HSTAG)
        order = "F"
    want = _jax_lattice(LATTICE)
    _close(got["DENS"].reshape(NLAT, no, order=order), want.get_dens(),
           TOL["obs"], "dens")
    _close(got["DOCC"].reshape(NLAT, no, order=order), want.get_docc(),
           TOL["obs"], "docc")
    _close(got["EIMP"].reshape(NLAT, 4, order=order), want.get_eimp(),
           TOL["obs"], "eimp")
    g = _pairs(got["G"], (NLAT, 1, 1, no, no, lm), order)
    _close(g, want.get_gimp(), TOL["gimp"], "G")
    assert got["DENS"][0] > got["DENS"][1]      # the staggered Hloc


def test_compat_site_driver(built, jax_cpu):
    """The reference ABI's single site, its G, and its chi2 fit (L-BFGS-B)
    against ed_solve and ed_chi2_fitgf."""
    got = _run(built, "compat_site", built[1]["lattice"])
    cfg = j_set_config(j_config(**LATTICE, ed_verbose=0))
    bath = jed.ed_init_solver(cfg=cfg)
    assert got["NB"][0] == bath.size
    jed.ed_set_hloc(np.zeros((1, 1, 1, 1)))
    jed.ed_solve(bath)
    for key, want in (("DENS", jed.ed_get_dens()), ("DOCC", jed.ed_get_docc()),
                      ("EIMP", jed.ed_get_eimp())):
        _close(got[key], want, TOL["obs"], key)
    g = jed.ed_get_gimp()
    _close(_pairs(got["G"], g.shape, "F"), g, TOL["gimp"], "G")
    fit = jed.ed_chi2_fitgf(g, bath, ispin=1)
    _close(got["FIT"], fit, TOL["bath"], "fitted bath")


@pytest.mark.parametrize("value, message", [
    ("cpu'); import os; ('", "is not one of: cuda, cuda:N, cpu"),
    ("gpu", "is not one of: cuda, cuda:N, cpu"),
    ("cuda", "CUDA device requested but torch.cuda is not available")])
def test_device_switch_fails_through_last_error(built, value, message):
    """EDIPACK_TPU_TORCH_DEVICE outside the list, or cuda without CUDA:
    edtpu_init returns -1 and edtpu_last_error() holds the message; the
    value is never run as code."""
    if value == "cuda" and torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    out = _run(built, "edtpu_site", built[1]["site"], 1, 2, SITE["lmats"],
               device=value, ok=False)
    assert out.returncode == 1
    assert out.stdout.startswith("ERR "), out.stdout + out.stderr
    assert message in out.stdout
    assert "EVALS" not in out.stdout


def test_capihelp_helpers_against_jax(tmp_path, monkeypatch, jax_cpu):
    """The flat-buffer helpers (capihelp) against edipack_tpu's, as
    tests/test_capi.py::test_capihelp_ineq_and_replica_helpers runs them,
    and the library device's allowlist in Python."""
    import importlib
    import edipack_tpu.capihelp as jch
    import edipack_tpu_torch.config as tconfig
    monkeypatch.setenv("EDIPACK_TPU_TORCH_DEVICE", "cpu")
    ch = importlib.import_module("edipack_tpu_torch.capihelp")
    assert ch.library_device() == torch.device("cpu")
    monkeypatch.setenv("EDIPACK_TPU_TORCH_DEVICE", "cuda:0; x")
    with pytest.raises(ValueError, match="is not one of"):
        ch.library_device()
    kw = dict(norb=1, nbath=2, nspin=1, uloc=[1.5], lmats=8, lfit=8,
              cg_method=1, cg_scheme="delta", ed_output_dir=str(tmp_path),
              ed_verbose=0)
    out = []
    for mod, cfgmod in ((jch, None), (ch, tconfig)):
        if cfgmod is None:
            j_set_config(j_config(**kw))
        else:
            cfgmod.set_config(cfgmod.default_config(**kw))
        mod.ineq_init(2)
        baths = mod.ineq_init_solver()
        nb = baths.shape[1]
        mod.ineq_set_hloc([0.2, -0.2], None, 1, per_site=1)
        mod.ineq_solve(baths.ravel(), nb, flag_gf=1)
        flat = mod.ineq_get("gimp")[:, 0, 0, 0, 0].ravel()
        fit = mod.ineq_fit_gf(np.stack([flat.real, flat.imag], -1).ravel(),
                              8, baths.ravel(), nb)
        out.append(dict(baths=baths, dens=mod.ineq_get("dens"),
                        g=mod.ineq_get("gimp"), eimp=mod.ineq_get("eimp"),
                        fit=fit))
    want, got = out
    assert ch._ineq.device == torch.device("cpu")
    assert np.array_equal(got["baths"], want["baths"])
    for key, tol in (("dens", TOL["obs"]), ("eimp", TOL["obs"]),
                     ("g", TOL["gimp"]), ("fit", TOL["bath"])):
        assert np.shape(got[key]) == np.shape(want[key]), key
        _close(got[key], want[key], tol, key)
    assert got["dens"][0, 0] < got["dens"][1, 0]
    v = ch.complex_from_pairs([1.0, 2.0, 3.0, -4.0])
    assert np.array_equal(v, [1 + 2j, 3 - 4j])
    # replica basis through the flat setter, then a solve on the device
    from edipack_tpu_torch.bath.user import clear_global_basis
    cfg2 = tconfig.set_config(tconfig.default_config(
        norb=1, nbath=2, nspin=1, bath_type="replica", uloc=[1.0],
        ed_output_dir=str(tmp_path), ed_verbose=0))
    eye = np.ones(1)
    try:
        ch.set_hreplica_flat(eye.tolist(), None, 1, 1, 1, [0.3], 2)
        bath = ch.init_solver()
        import edipack_tpu_torch as ted
        ted.ed_set_hloc(np.zeros((1, 1)))
        assert ted.ed_solve(bath).e0 < 0
        assert ted.main._S().device == torch.device("cpu")
    finally:
        ted.ed_finalize_solver()
        clear_global_basis()
        tconfig.set_config(tconfig.EDConfig())
    assert cfg2.bath_type == "replica"
