"""The normal-mode ed_* API of edipack_tpu_torch beyond the solve, against
edipack_tpu on the CPU (mirrors tests/test_main_api.py): runtime and file
two-body terms against Kanamori, ed_update_input, the energy, density-
matrix and phonon getters, the replica bath dimension, the names and
signatures of the API, and the joint-mode names that raise until that
slice is ported.
"""
import inspect
import os

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.config import default_config as j_config
from edipack_tpu.config import set_config as j_set_config

import edipack_tpu_torch
import edipack_tpu_torch.main as ted
from edipack_tpu_torch.config import default_config, set_config

torch.set_num_threads(1)
TOL = dict(e0=1e-10, obs=1e-8, gf=1e-8)
DELTA = 0.5
# tests/test_main_api.py's model
BASE = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=2.0, jh=0.125,
            jx=0.125, jp=0.125, beta=1000.0, lmats=64, xmu=0.0,
            lanc_nstates_sector=2)
KANAMORI_AS_TERMS = [
    (1, "u", 1, "d", 1, "u", 1, "d", 2.0), (1, "d", 1, "u", 1, "d", 1, "u", 2.0),
    (2, "u", 2, "d", 2, "u", 2, "d", 2.0), (2, "d", 2, "u", 2, "d", 2, "u", 2.0),
    (1, "d", 2, "u", 1, "d", 2, "u", 2.0), (1, "u", 2, "d", 1, "u", 2, "d", 2.0),
    (2, "d", 1, "u", 2, "d", 1, "u", 2.0), (2, "u", 1, "d", 2, "u", 1, "d", 2.0),
    (1, "u", 2, "u", 1, "u", 2, "u", 2.0), (1, "d", 2, "d", 1, "d", 2, "d", 2.0),
    (2, "u", 1, "u", 2, "u", 1, "u", 2.0), (2, "d", 1, "d", 2, "d", 1, "d", 2.0),
    (1, "u", 2, "u", 2, "u", 1, "u", 0.125), (1, "d", 2, "d", 2, "d", 1, "d", 0.125),
    (2, "u", 1, "u", 1, "u", 2, "u", 0.125), (2, "d", 1, "d", 1, "d", 2, "d", 0.125),
    (1, "d", 2, "u", 2, "d", 1, "u", 0.125), (1, "u", 2, "d", 2, "u", 1, "d", 0.125),
    (2, "d", 1, "u", 1, "d", 2, "u", 0.125), (2, "u", 1, "d", 1, "u", 2, "d", 0.125),
    (1, "d", 1, "u", 2, "d", 2, "u", 0.125), (1, "u", 1, "d", 2, "u", 2, "d", 0.125),
    (2, "d", 2, "u", 1, "d", 1, "u", 0.125), (2, "u", 2, "d", 1, "u", 1, "d", 0.125),
]
# the names of edipack_tpu/main.py ported in the extras slice
EXTRAS_NAMES = [
    "ed_get_epot", "ed_get_eint", "ed_get_ehartree", "ed_get_eknot",
    "ed_get_ephon", "ed_get_phon", "ed_get_nsectors", "ed_get_sp_dm",
    "ed_get_denmat", "ed_get_imp_info", "ed_set_g_ph", "ed_set_a_ph",
    "ed_update_input", "ed_build_impd", "ed_read_impdmatrix",
    "ed_add_twobody_operator", "ed_reset_umatrix", "ed_read_umatrix_file",
    "ed_save_umatrix_file", "ed_get_bath_dimension",
    "ed_get_chi", "ed_get_spinchi", "ed_get_denschi", "ed_get_pairchi",
    "ed_get_exctchi", "ed_build_spinchi", "ed_build_denschi",
    "ed_build_pairchi", "ed_build_exctchi", "ed_read_spinchimatrix",
    "ed_read_denschimatrix", "ed_read_pairchimatrix",
    "ed_read_exctchimatrix",
    "ed_get_rdm", "ed_get_impurity_rdm", "ed_get_reduced_rdm",
    "ed_build_krylov_state_complexity", "ed_build_krylov_operator_complexity",
    "ed_get_ksc", "ed_get_ssc", "ed_get_psc", "ed_get_koc", "ed_get_soc",
    "ed_get_poc",
]
# superc / nonsu2 results: the joint-mode slice
JOINT_NAMES = {"ed_get_quantum_soc_operators": (), "ed_get_phi": (),
               "ed_get_argphi": (), "ed_get_exct": (),
               "ed_build_impf": (1j,), "ed_build_self": (1j,)}


def _hloc(norb=2):
    h = np.zeros((1, 1, norb, norb))
    h[0, 0] = DELTA * np.diag([1.0, -1.0])[:norb, :norb]
    return h


@pytest.fixture(scope="module")
def one_device():
    """edipack_tpu as on a single-device host (the suite's virtual
    8-device CPU mesh would shard its dense buckets, which only costs
    compile time here)."""
    import jax
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        yield


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _run(mod, cfg, terms=(), update=(), hloc=None):
    """ed_init_solver -> ed_set_hloc -> runtime terms -> ed_update_input ->
    ed_solve through the API of ``mod``; the getters' values."""
    kw = {} if mod is jed else dict(device="cpu")
    bath = mod.ed_init_solver(cfg=cfg, **kw)
    mod.ed_set_hloc(_hloc(cfg.norb) if hloc is None else hloc)
    for t in terms:
        mod.ed_add_twobody_operator(*t)
    for name, vals in update:
        mod.ed_update_input(name, vals)
    res = mod.ed_solve(bath)
    z = 1j * (2 * np.arange(32) + 1) * np.pi / cfg.beta
    out = dict(e0=float(res.e0), dens=mod.ed_get_dens().copy(),
               docc=mod.ed_get_docc().copy(), mag=np.asarray(mod.ed_get_mag()),
               energy=mod.ed_get_eimp().copy(),
               parts=np.array([mod.ed_get_epot(), mod.ed_get_eint(),
                               mod.ed_get_ehartree(), mod.ed_get_eknot()]),
               doubles=mod.ed_get_doubles().copy(),
               evals=mod.ed_get_evals().copy(),
               sigma=mod.ed_get_sigma(z), sp_dm=mod.ed_get_sp_dm().copy(),
               denmat=mod.ed_get_denmat(), info=mod.ed_get_imp_info(),
               evals_all=res.evals_all)
    if cfg.nph:
        out.update(phon=mod.ed_get_phon(), ephon=mod.ed_get_ephon(),
                   dimp=mod.ed_build_impd(1j * np.array([0.5, 1.0])))
    mod.ed_finalize_solver()
    return out


def _assert_same(got, want, tol_sigma=TOL["gf"]):
    assert abs(got["e0"] - want["e0"]) <= TOL["e0"]
    assert np.abs(got["evals"] - want["evals"]).max() <= TOL["e0"]
    for k in got:
        if k in ("e0", "evals", "evals_all"):
            continue
        tol = tol_sigma if k in ("sigma", "dimp") else TOL["obs"]
        assert np.shape(got[k]) == np.shape(want[k]), k
        assert np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() \
            <= tol, k


@pytest.fixture(scope="module")
def kanamori_jax(one_device, tmp_path_factory):
    old = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("kanamori_jax"))
    try:
        return _run(jed, j_set_config(j_config(**BASE, ed_verbose=0)))
    finally:
        os.chdir(old)


def test_kanamori_getters_vs_jax(kanamori_jax, workdir):
    """The Kanamori solve's getters against edipack_tpu's, and the density
    matrix invariants (reference ed_normal_normal.f90:213-248)."""
    got = _run(ted, set_config(default_config(**BASE, ed_verbose=0)))
    _assert_same(got, kanamori_jax)
    assert np.array_equal(got["parts"], got["energy"])
    assert np.abs(got["evals_all"][:4] - kanamori_jax["evals_all"][:4]
                  ).max() <= TOL["e0"]
    dm = got["sp_dm"][0]
    assert np.allclose(dm, dm.conj().T, atol=1e-9)
    assert np.allclose(np.real(np.diag(dm))[:2] * 2, got["dens"], atol=1e-7)
    assert got["denmat"].shape == (1, 1, 6, 6)
    assert np.array_equal(got["denmat"][0, 0], dm)
    assert ted.ed_get_nsectors() == jed.ed_get_nsectors() == 49


def test_runtime_umatrix_vs_kanamori(kanamori_jax, workdir):
    """Kanamori given as runtime two-body terms (ed_use_kanamori=False):
    the port against edipack_tpu's Kanamori solve; ed_reset_umatrix
    drops the terms."""
    cfg = set_config(default_config(**BASE, ed_verbose=0,
                                    ed_use_kanamori=False))
    got = _run(ted, cfg, terms=KANAMORI_AS_TERMS)
    _assert_same(got, kanamori_jax)
    solver = ted.EDSolver(cfg, device="cpu")
    solver.add_twobody_operator(*KANAMORI_AS_TERMS[0])
    assert len(solver.runtime_terms) == 1
    solver.reset_umatrix()
    assert solver.runtime_terms == []


def test_umatrix_file_from_jax(kanamori_jax, workdir):
    """A umatrix file written by edipack_tpu: read through the
    ed_read_umatrix input and through ed_read_umatrix_file; the port's
    ed_save_umatrix_file writes the same text."""
    from edipack_tpu.umatrix import build_umatrix as j_umatrix
    from edipack_tpu.umatrix import save_umatrix_file as j_save
    j_save(j_umatrix(j_config(**BASE)), str(workdir / "umatrix.restart"))
    cfg = set_config(default_config(
        **BASE, ed_verbose=0, ed_use_kanamori=False, ed_read_umatrix=True,
        umatrix_file=str(workdir / "umatrix")))
    _assert_same(_run(ted, cfg), kanamori_jax)
    cfg = set_config(default_config(**BASE, ed_verbose=0,
                                    ed_use_kanamori=False))
    ted.ed_init_solver(cfg=cfg, device="cpu")
    ted.ed_read_umatrix_file(str(workdir / "umatrix.restart"))
    assert len(ted._S().runtime_terms) == int(
        (workdir / "umatrix.restart").read_text().split()[0])
    ted.ed_save_umatrix_file(str(workdir / "umatrix_torch.restart"))
    assert (workdir / "umatrix_torch.restart").read_text() \
        == (workdir / "umatrix.restart").read_text()
    ted.ed_set_hloc(_hloc())
    res = ted.ed_solve()
    assert abs(res.e0 - kanamori_jax["e0"]) <= TOL["e0"]
    ted.ed_finalize_solver()


def test_update_input_vs_jax(one_device, workdir):
    """SPIN_FIELD_Z and EXC_FIELD changed at run time, in both packages;
    wrong names and sizes raise."""
    update = [("SPIN_FIELD_Z", [0.05, -0.02]),
              ("EXC_FIELD", [0.03, 0.0, 0.0, 0.01])]
    model = dict(BASE, nbath=1)
    want = _run(jed, j_set_config(j_config(**model, ed_verbose=0)),
                update=update)
    got = _run(ted, set_config(default_config(**model, ed_verbose=0)),
               update=update)
    _assert_same(got, want)
    assert abs(got["mag"][0]) > 1e-4
    ted.ed_init_solver(cfg=set_config(default_config(**model)), device="cpu")
    for name, vals in (("NO_FIELD", [0.0, 0.0]), ("SPIN_FIELD_X", [0.1]),
                       ("EXC_FIELD", [0.1, 0.2])):
        with pytest.raises(ValueError):
            ted.ed_update_input(name, vals)
    ted.ed_update_input("spin_field_x", [0.1, 0.2])
    assert ted._S().cfg.spin_field_x[:2] == [0.1, 0.2]
    ted.ed_finalize_solver()


def test_phonon_getters_vs_jax(one_device, workdir):
    """ed_set_g_ph / ed_set_a_ph before the solve, then ed_get_phon,
    ed_get_ephon and ed_build_impd, in both packages."""
    model = dict(norb=1, nbath=2, nspin=1, uloc=[2.0], xmu=0.2, nph=3,
                 w0_ph=0.8, g_ph=[0.1], lanc_dim_threshold=16)
    out = {}
    for mod, setc, mk in ((jed, j_set_config, j_config),
                          (ted, set_config, default_config)):
        cfg = setc(mk(**model, ed_verbose=0))
        kw = {} if mod is jed else dict(device="cpu")
        bath = mod.ed_init_solver(cfg=cfg, **kw)
        mod.ed_set_hloc(np.zeros((1, 1, 1, 1)))
        mod.ed_set_g_ph(np.array([[0.3]]))
        mod.ed_set_a_ph(0.05)
        mod.ed_solve(bath)
        out[mod] = dict(phon=mod.ed_get_phon(), ephon=mod.ed_get_ephon(),
                        dimp=mod.ed_build_impd(1j * np.array([0.5, 1.0])),
                        g_ph=mod._S().cfg.g_ph[0], a_ph=mod._S().cfg.a_ph)
        mod.ed_finalize_solver()
    got, want = out[ted], out[jed]
    assert got["g_ph"] == want["g_ph"] == 0.3 and got["a_ph"] == 0.05
    for k in ("phon", "ephon", "dimp"):
        assert np.abs(got[k] - want[k]).max() <= TOL["obs"], k
    assert ted.ed_read_impdmatrix is ted.ed_read_impgmatrix


def test_bath_dimension_replica_basis(workdir):
    """ed_get_bath_dimension() counts the replica basis set by
    ed_set_hreplica, as edipack_tpu's does (norb=1, nbath=3, two basis
    matrices: 10); without the basis it raised ValueError."""
    from edipack_tpu.bath import user as j_user
    from edipack_tpu_torch.bath import user as t_user
    ops = np.zeros((2, 1, 1, 1, 1), complex)
    ops[0] = 1.0
    ops[1] = 0.5
    lam = np.array([[0.3, 1.0], [-0.3, 1.0], [0.1, 0.5]])
    model = dict(norb=1, nbath=3, nspin=1, bath_type="replica")
    try:
        j_set_config(j_config(**model))
        j_user.ed_set_hreplica(ops, lam)
        set_config(default_config(**model))
        t_user.ed_set_hreplica(ops, lam)
        want = jed.ed_get_bath_dimension()
        assert ted.ed_get_bath_dimension() == want == 10
    finally:
        j_user.clear_global_basis()
        t_user.clear_global_basis()
    assert ted.ed_get_bath_dimension(default_config(norb=1, nbath=3)) == 6


def test_extras_names_and_signatures():
    """Every normal-mode name of the extras slice exists in
    edipack_tpu_torch.main and the package, with edipack_tpu's
    signature."""
    import edipack_tpu
    for name in EXTRAS_NAMES:
        fn = getattr(ted, name)
        assert getattr(edipack_tpu_torch, name) is fn, name
        assert name in edipack_tpu_torch.__all__, name
        assert inspect.signature(fn) == inspect.signature(
            getattr(jed, name)), name
        assert hasattr(edipack_tpu, name), name
    for name in JOINT_NAMES:
        assert inspect.signature(getattr(ted, name)) == inspect.signature(
            getattr(jed, name)), name
        assert getattr(edipack_tpu_torch, name) is getattr(ted, name)


@pytest.mark.parametrize("name", sorted(JOINT_NAMES))
def test_joint_mode_names_raise(name):
    with pytest.raises(NotImplementedError, match="joint modes"):
        getattr(ted, name)(*JOINT_NAMES[name])
