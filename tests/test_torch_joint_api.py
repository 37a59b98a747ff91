"""The superc / nonsu2 ed_* API of edipack_tpu_torch against edipack_tpu on
the CPU: the six joint getters (ed_get_phi, ed_get_argphi, ed_get_exct,
ed_build_impf, ed_build_self, ed_get_quantum_soc_operators), the impF /
impSelf and quantum_SOC_operators files number by number, a complex Hloc
in ed_mode=normal (solved through nonsu2, results in the normal-mode
shapes), the convert.py round trips of superc / nonsu2 / replica baths and
their restart files, the replica basis of ed_init_solver, and the joint
golden (tests/data/torch_port_golden_joint.json, slow)."""
import glob
import inspect
import json
import os

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.bath import user as j_user
from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.bath.dmft_bath import save_bath_file as j_save_bath_file
from edipack_tpu.bath.replica import make_basis as j_make_basis
from edipack_tpu.bath.replica import save_hbasis as j_save_hbasis
from edipack_tpu.config import default_config as j_config
from edipack_tpu.config import get_config as j_get_config
from edipack_tpu.config import set_config as j_set_config

import edipack_tpu_torch
import edipack_tpu_torch.main as ted
from edipack_tpu_torch.bath import user as t_user
from edipack_tpu_torch.bath.dmft_bath import bath_to_array
from edipack_tpu_torch.config import default_config, get_config, set_config
from edipack_tpu_torch.bath.replica import ReplicaBasis
from edipack_tpu_torch.convert import bath_from_array

import joint_cases as jc

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_golden_joint.json")
FILE_TOL = 1e-8
JOINT_NAMES = ("ed_get_quantum_soc_operators", "ed_get_phi",
               "ed_get_argphi", "ed_get_exct", "ed_build_impf",
               "ed_build_self")
# small cases of the API checks (tests/joint_cases.py layout)
API_CASES = {
    "superc": dict(config=dict(norb=1, nbath=3, ed_mode="superc",
                               uloc=[-2.0], deltasc=0.1, xmu=0.1),
                   hloc=np.full((1, 1, 1, 1), 0.05 + 0j),
                   hloc_anomalous=np.array([[0.03]], complex)),
    "soc": jc.CASES["soc"],
    "cplx_normal": dict(config=dict(norb=2, nbath=1, nspin=1,
                                    uloc=[2.0, 1.5], ust=1.0, jh=0.2),
                        hloc=np.array([[[[0.1, 0.1j], [-0.1j, -0.1]]]])),
}


@pytest.fixture(autouse=True)
def keep_global_configs():
    """Both packages' global configs as the test found them."""
    saved = j_get_config(), get_config()
    yield
    j_set_config(saved[0])
    set_config(saved[1])


def _run_in(path, mod_name, case, **extra):
    """run_case of ``case`` through package ``mod_name`` in the directory
    ``path`` with ed_write_files on; its results."""
    os.makedirs(path, exist_ok=True)
    old = os.getcwd()
    os.chdir(path)
    try:
        case = dict(case, config=dict(case["config"], ed_write_files=True,
                                      lmats=64, lreal=64, **extra))
        dev = "cpu" if mod_name.endswith("torch") else None
        return jc.run_case(jc.modules(mod_name), case, device=dev)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def api_runs(tmp_path_factory):
    """Each API case through both packages, files written to their own
    directories."""
    root = tmp_path_factory.mktemp("joint_api")
    out = {}
    for name, case in API_CASES.items():
        out[name] = {mod: (_run_in(str(root / name / mod), mod, case),
                           str(root / name / mod))
                     for mod in ("edipack_tpu", "edipack_tpu_torch")}
    return out


@pytest.mark.parametrize("name", list(API_CASES))
def test_joint_api_against_jax(api_runs, name):
    """The solve's results and the joint getters, at the golden's
    tolerances."""
    (want, _), (got, _) = (api_runs[name]["edipack_tpu"],
                           api_runs[name]["edipack_tpu_torch"])
    dev = jc.deviations(got, want)
    bad = {k: v for k, v in dev.items() if not v <= jc.TOL[k]}
    assert not bad, bad
    assert set(got) == set(want)
    if name == "cplx_normal":
        # results in the caller's normal-mode (nspin=1) shapes
        assert got["gimp"].shape == (1, 1, 2, 2, jc.NMATS)
        assert np.abs(got["gimp"][0, 0, 0, 1]).max() > 1e-6


def _numbers(path):
    """Every number of a text output file, comment lines skipped."""
    with open(path) as fh:
        return np.array([float(t) for line in fh if not line.startswith("#")
                         for t in line.split()])


@pytest.mark.parametrize("pattern", ["impF_*", "impSelf_*", "impG_*",
                                     "impSigma_*", "quantum_SOC_operators*"])
def test_joint_files_against_jax(api_runs, pattern):
    """The text files of both packages: the same names, and the same
    numbers on the Matsubara axis and in the SOC-operator file. (On the
    real axis, ω + 0.01i, the poles of the 200-step GF chains of the
    norb=3 sectors move with the rounding of each package's chain, and G
    differs by up to 1e-6 of its size there.)"""
    seen = 0
    for name in API_CASES:
        jdir = api_runs[name]["edipack_tpu"][1]
        tdir = api_runs[name]["edipack_tpu_torch"][1]
        jfiles = sorted(os.path.basename(p)
                        for p in glob.glob(os.path.join(jdir, pattern)))
        tfiles = sorted(os.path.basename(p)
                        for p in glob.glob(os.path.join(tdir, pattern)))
        assert tfiles == jfiles, name
        for f in jfiles:
            if f.endswith("_realw.ed"):
                continue
            a = _numbers(os.path.join(jdir, f))
            b = _numbers(os.path.join(tdir, f))
            assert a.shape == b.shape, f
            assert np.abs(a - b).max() <= FILE_TOL * max(1.0,
                                                         np.abs(a).max()), f
            seen += 1
    assert seen > 0


def test_joint_names_and_signatures():
    """The joint getters exist in the package with edipack_tpu's
    signatures; ed_set_hloc takes the anomalous Hloc."""
    for name in JOINT_NAMES + ("ed_set_hloc",):
        fn = getattr(ted, name)
        assert getattr(edipack_tpu_torch, name) is fn, name
        assert inspect.signature(fn) == inspect.signature(getattr(jed, name))


def _replica_basis_model():
    ops = np.zeros((2, 1, 1, 1, 1), complex)
    ops[0] = 1.0
    ops[1] = 0.5
    lam = np.array([[0.3, 1.0], [-0.3, 1.0], [0.1, 0.5]])
    return dict(norb=1, nbath=3, nspin=1, bath_type="replica"), ops, lam


def test_init_solver_replica_basis_and_bfile(tmp_path, monkeypatch):
    """ed_init_solver sizes a replica bath with the basis set by
    ed_set_hreplica (norb=1, nbath=3, two basis matrices: 10 entries, as
    edipack_tpu's), and re-reads the basis from <bfile>.restart when it
    exists, as edipack_tpu does."""
    monkeypatch.chdir(tmp_path)
    model, ops, lam = _replica_basis_model()
    try:
        j_set_config(j_config(**model))
        j_user.ed_set_hreplica(ops, lam)
        want = jed.ed_init_solver(cfg=j_config(**model))
        set_config(default_config(**model))
        t_user.ed_set_hreplica(ops, lam)
        got = ted.ed_init_solver(cfg=default_config(**model), device="cpu")
        assert got.size == want.size == 10
        assert np.array_equal(got, want)
        # a basis file written by edipack_tpu replaces the set basis
        ops2 = ops.copy()
        ops2[1] = -0.25
        j_save_hbasis(j_make_basis(ops2, lam), "hbasis.restart")
        j_user.ed_set_hreplica(ops, lam)
        want2 = jed.ed_init_solver(cfg=j_config(**model))
        t_user.ed_set_hreplica(ops, lam)
        got2 = ted.ed_init_solver(cfg=default_config(**model), device="cpu")
        assert np.array_equal(got2, want2)
        assert np.array_equal(t_user.get_global_basis().ops,
                              j_user.get_global_basis().ops)
        assert t_user.get_global_basis().ops[1, 0, 0, 0, 0] == -0.25
    finally:
        j_user.clear_global_basis()
        t_user.clear_global_basis()
        jed.ed_finalize_solver()
        ted.ed_finalize_solver()


BATHS = {
    "superc-normal": dict(norb=2, nbath=2, ed_mode="superc"),
    "superc-hybrid": dict(norb=2, nbath=2, ed_mode="superc",
                          bath_type="hybrid"),
    "nonsu2-normal": dict(norb=2, nbath=2, nspin=2, ed_mode="nonsu2"),
    "nonsu2-hybrid": dict(norb=2, nbath=2, nspin=2, ed_mode="nonsu2",
                          bath_type="hybrid"),
    "superc-replica": dict(norb=2, nbath=2, ed_mode="superc",
                           bath_type="replica"),
    "nonsu2-general": dict(norb=2, nbath=2, nspin=2, ed_mode="nonsu2",
                           bath_type="general"),
}


@pytest.mark.parametrize("name", list(BATHS))
def test_convert_bath_round_trip(name, tmp_path, monkeypatch):
    """An edipack_tpu bath array (perturbed) -> convert.bath_from_array ->
    bath_to_array gives it back exactly; the hamiltonian.restart that
    edipack_tpu writes seeds the port's ed_init_solver to the same
    array."""
    monkeypatch.chdir(tmp_path)
    model = BATHS[name]
    jcfg, cfg = j_config(**model), default_config(**model)
    jb = tb = None
    if cfg.bath_type in ("replica", "general"):
        ns = cfg.nspin if cfg.ed_mode != "superc" else 2
        ops = np.zeros((2, ns, ns, 2, 2), complex)
        ops[0, 0, 0] = ops[0, -1, -1] = np.eye(2)
        ops[1, 0, -1] = ops[1, -1, 0] = np.array([[0, 1], [1, 0]])
        if ns == 2 and cfg.ed_mode == "superc":
            ops[0, 1, 1] = -np.eye(2)
        lam = np.array([[0.4, 0.1], [-0.3, 0.2]])
        jb = j_make_basis(ops, lam)
        tb = ReplicaBasis(jb.ops, jb.linit)
    jbath = j_init_bath(jcfg, jb)
    arr = j_bath_to_array(jbath)
    arr = arr + 0.01 * np.arange(arr.size) * (np.arange(arr.size) > 0)
    assert np.array_equal(bath_to_array(bath_from_array(arr, cfg, tb)), arr)
    from edipack_tpu.bath.dmft_bath import array_to_bath as j_array_to_bath
    j_save_bath_file(j_array_to_bath(arr, jcfg, jb), "hamiltonian.restart")
    try:
        if tb is not None:
            set_config(cfg)
            t_user.ed_set_hreplica(tb.ops, tb.linit)
        got = ted.ed_init_solver(cfg=cfg, device="cpu")
    finally:
        t_user.clear_global_basis()
        ted.ed_finalize_solver()
    assert np.abs(got - arr).max() <= 1e-12


@pytest.mark.slow
@pytest.mark.parametrize("name", list(jc.CASES))
def test_joint_golden_cpu(name, tmp_path, monkeypatch):
    """Each case of the joint golden through the port's ELL route on the
    CPU, held to the file as chip_smoke.py holds the card (the superc case
    alone takes about 35 s on one thread)."""
    monkeypatch.chdir(tmp_path)
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    pkg = jc.modules("edipack_tpu_torch")
    got = jc.run_case(pkg, jc.CASES[name], device="cpu")
    dev = jc.deviations(got, jc.from_json(gold["cases"][name], got))
    bad = {k: v for k, v in dev.items() if not v <= jc.TOL[k]}
    assert not bad, bad
