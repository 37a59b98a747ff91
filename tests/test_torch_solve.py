"""The normal-mode slice end to end: edipack_tpu_torch driven through
ed_init_solver / ed_set_hloc / ed_solve on the CPU, through both matvec
routes (the fused operator's plain version and KronMatvec), against the
edipack_tpu package's ed_solve (f64 KronMatvec, exact GF moments on the
CPU)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config

import edipack_tpu_torch.main as ted
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.convert import config_from_jax
from edipack_tpu_torch.ops import fused_matvec as fm

torch.set_num_threads(1)
NMATS = 32
TOL = dict(e0=1e-10, obs=1e-8, gf=1e-8)
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
CONFIGS = {
    "config1": dict(norb=1, nbath=4, nspin=1),
    "kanamori_n2b3": dict(norb=2, nbath=3, nspin=1, **KANAMORI),
}
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden_n2b4.json")


def _z(beta):
    return 1j * np.pi / beta * (2 * np.arange(NMATS) + 1)


def _summary(mod, res, beta):
    z = _z(beta)
    return dict(e0=float(res.e0), dens=np.asarray(mod.ed_get_dens()),
                docc=np.asarray(mod.ed_get_docc()),
                energies=np.asarray(mod.ed_get_eimp()),
                evals=np.asarray(mod.ed_get_evals()),
                neigen=np.asarray(mod.ed_get_neigen_sector()),
                gimp=mod.ed_get_gimp(z), sigma=mod.ed_get_sigma(z),
                g0=mod.ed_get_g0imp(z))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Run in an empty directory: both packages look for restart / Hloc
    files in the working directory."""
    old = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("torch_solve"))
    yield
    os.chdir(old)


@pytest.fixture(scope="module")
def jax_ref(workdir):
    """edipack_tpu's solves as on a single-device host (the suite's virtual
    8-device CPU mesh would shard the dense buckets, which only costs
    compile time here)."""
    import jax
    devices = jax.devices
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        for name, kw in CONFIGS.items():
            jcfg = j_config(**kw, ed_verbose=0)
            bath = j_bath_to_array(j_init_bath(jcfg))
            jed.ed_init_solver(bath.copy(), cfg=jcfg)
            jed.ed_set_hloc(np.zeros((1, 1, jcfg.norb, jcfg.norb)))
            res = jed.ed_solve()
            out[name] = (jcfg, bath, _summary(jed, res, jcfg.beta))
            jed.ed_finalize_solver()
    return out


def _port_solve(jcfg, bath, route):
    cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
        ed_fused_matvec=route)
    ted.ed_init_solver(bath.copy(), cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    res = ted.ed_solve()
    return cfg, res, _summary(ted, res, cfg.beta)


def _assert_matches(got, ref, what=""):
    assert abs(got["e0"] - ref["e0"]) <= TOL["e0"], what
    assert np.array_equal(got["neigen"], ref["neigen"]), what
    assert np.abs(got["evals"] - ref["evals"]).max() <= TOL["e0"], what
    for k in ("dens", "docc", "energies"):
        assert np.abs(got[k] - ref[k]).max() <= TOL["obs"], (what, k)
    for k in ("gimp", "sigma", "g0"):
        assert got[k].shape == ref[k].shape
        assert np.abs(got[k] - ref[k]).max() <= TOL["gf"], (what, k)


@pytest.mark.parametrize("route", ["always", "never"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_vs_jax(jax_ref, name, route):
    jcfg, bath, ref = jax_ref[name]
    before = fm.launches
    cfg, res, got = _port_solve(jcfg, bath, route)
    _assert_matches(got, ref, f"{name}/{route}")
    assert fm.launches == before      # CPU tensors never launch the kernel
    assert res.device == torch.device("cpu")
    assert set(res.timings) == {"diagonalization", "greens_functions",
                                "observables"}
    # which operator each Lanczos-sized sector took
    lanczos = any(res.table.get_dim(i) > cfg.lanc_dim_threshold
                  for i in range(len(res.table)))
    assert (res.n_matvecs > 0) == lanczos
    ted.ed_finalize_solver()


def test_fused_route_selection(jax_ref):
    """auto keeps KronMatvec on the CPU; always takes the fused operator."""
    from edipack_tpu_torch.solver.core import _normal_builders
    from edipack_tpu_torch.umatrix import build_umatrix
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.convert import bath_from_array
    jcfg, bath, _ = jax_ref["kanamori_n2b3"]
    types = {}
    for route in ("auto", "always", "never"):
        cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
            ed_fused_matvec=route)
        table = SectorTable(cfg)
        b = _normal_builders(cfg, table, np.zeros((1, 1, 2, 2)),
                             build_umatrix(cfg), bath_from_array(bath, cfg),
                             torch.device("cpu"))
        sec = table.by_qn(("n", (4,), (4,)))
        types[route] = type(b.matvec_builder(sec)).__name__
    assert types == {"auto": "KronMatvec", "always": "FusedKron",
                     "never": "KronMatvec"}


def test_successive_solve_feedback(jax_ref):
    """A second ed_solve reuses the adapted neigen_sector, as edipack_tpu
    does."""
    jcfg, bath, ref = jax_ref["config1"]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    ted.ed_init_solver(bath.copy(), cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.zeros((1, 1, 1, 1)))
    ted.ed_solve()
    first = np.asarray(ted.ed_get_neigen_sector()).copy()
    res2 = ted.ed_solve(bath)
    assert np.array_equal(first, ref["neigen"])
    assert abs(res2.e0 - ref["e0"]) <= TOL["e0"]
    ted.ed_finalize_solver()


def test_cuda_device_required(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ted.ed_init_solver(cfg=default_config(norb=1, nbath=2))


@pytest.mark.parametrize("field,value", [
    ("ed_mode", "superc"), ("ed_finite_temp", True), ("chispin_flag", True),
    ("rdm_flag", True), ("ed_total_ud", False), ("bath_type", "replica"),
])
def test_unported_inputs_raise(field, value):
    """Inputs that slices after the first ported (superc and replica baths
    with the joint modes; finite T, χ, RDM and per-orbital sectors with the
    extras) are accepted: the solver takes the configuration as it is."""
    kw = dict(norb=1, nbath=2, nspin=1)
    if field == "ed_finite_temp":
        kw["lanc_nstates_total"] = 4
    cfg = default_config(**kw).replace(**{field: value})
    assert ted.EDSolver(cfg, device="cpu").cfg == cfg


def test_complex_hloc_raises():
    """A complex Hloc in ed_mode=normal, which raised until the joint
    slice, is accepted and routed through the nonsu2 solve (its results:
    tests/test_torch_joint_api.py)."""
    solver = ted.EDSolver(default_config(norb=1, nbath=2), device="cpu")
    solver.init_solver()
    solver.set_hloc(np.full((1, 1, 1, 1), 0.1j))
    assert solver._cplx_normal_active()
    cfg2, h2, _ = solver._promote_to_nonsu2()
    assert cfg2.ed_mode == "nonsu2" and cfg2.nspin == 2
    assert h2[0, 0, 0, 0] == h2[1, 1, 0, 0] == 0.1j


@pytest.mark.slow
def test_slice_vs_golden_n2b4(workdir):
    """norb=2, nbath=4 on the CPU against the edipack_tpu numbers that
    chip_smoke.py holds the card to (tests/gen_torch_golden.py)."""
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    cfg = default_config(**gold["config"], ed_verbose=0,
                         ed_fused_matvec="always")
    ted.ed_init_solver(np.asarray(gold["bath"]), cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    res = ted.ed_solve()
    z = _z(cfg.beta)
    cplx = lambda a: np.asarray(a)[..., 0] + 1j * np.asarray(a)[..., 1]
    assert abs(res.e0 - gold["e0"]) <= TOL["e0"]
    assert np.abs(res.evals - np.asarray(gold["evals"])).max() <= TOL["e0"]
    for k, got in (("dens", res.dens), ("docc", res.docc),
                   ("energies", res.energies)):
        assert np.abs(got - np.asarray(gold[k])).max() <= TOL["obs"], k
    assert np.abs(ted.ed_get_gimp(z) - cplx(gold["gimp"])).max() <= TOL["gf"]
    assert np.abs(ted.ed_get_sigma(z) - cplx(gold["sigma"])).max() \
        <= TOL["gf"]
    ted.ed_finalize_solver()
