"""Susceptibilities of edipack_tpu_torch (solver/chi.py) against
edipack_tpu's build_chi_normal on the CPU: the same seeded inputs through
both packages, through the fused operator's plain version (route
``always``) and KronMatvec (``never``). Mirrors
tests/test_phonon_chi_rdm.py::test_chi_spin_dens_exact,
tests/test_chi_exct.py and tests/test_total_ud.py.

χ is compared on the bosonic frequencies ν_1..ν_32, relative to its
largest value there, at 1e-8 (f64 on both sides). ν_0 = 0 is left out:
the Hermitian channels carry static poles at ±(E_n - E_i) with E_n = E_i
up to rounding, so χ(ν_0) is a ratio of rounding errors in both packages.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.solver.core import solve_impurity as j_solve
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.convert import bath_from_array, config_from_jax
from edipack_tpu_torch.ops import fused_matvec as fm
from edipack_tpu_torch.solver.core import solve_impurity
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
NMATS = 32
TOL = dict(e0=1e-10, obs=1e-8, gf=1e-8, chi=1e-8)
CPU = torch.device("cpu")
CHI_FLAGS = dict(chispin_flag=True, chidens_flag=True, chipair_flag=True,
                 chiexct_flag=True)
# two-orbital Kanamori at finite T: the three kept states, in (4,2),
# (2,4) and (3,3), carry two different Boltzmann weights, so a channel
# callback that took another state's weight or energy would show; the
# (3,3) sector (400 states) is above lanc_dim_threshold, so the chains
# that target it run Lanczos through the route's operator
FINITE_T_MODEL = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 1.6], ust=0.9,
                      jh=0.15, jx=0.1, jp=0.1, xmu=0.4, beta=8.0,
                      ed_finite_temp=True, lanc_nstates_total=3,
                      lanc_nstates_sector=2, lanc_dim_threshold=350,
                      cutoff=1e-6, **CHI_FLAGS)
CRYSTAL = np.diag([0.2, -0.2]).reshape(1, 1, 2, 2)
PHONON_MODEL = dict(norb=1, nbath=2, nspin=1, uloc=[2.0], xmu=0.2, nph=2,
                    w0_ph=0.6, g_ph=[0.25], lanc_dim_threshold=16,
                    chispin_flag=True, chidens_flag=True, chipair_flag=True)
# per-orbital sectors (ed_total_ud=False) need a density-density model
TOTAL_UD_MODEL = dict(norb=2, nbath=1, nspin=1, uloc=[2.0, 1.6], ust=0.9,
                      jh=0.15, xmu=0.4, beta=90.0, ed_total_ud=False,
                      lanc_dim_threshold=4, chispin_flag=True,
                      chidens_flag=True, chipair_flag=True, rdm_flag=True)


def _nu(beta):
    return 1j * 2 * np.pi / beta * np.arange(1, NMATS + 1)


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


def _both(model, hloc, routes=("always", "never")):
    """The JAX solve of ``model`` and the port's solve of the same inputs
    through each route."""
    jcfg = j_config(**model, ed_verbose=0)
    jbath = j_init_bath(jcfg)
    jres = j_solve(jcfg, hloc, j_umatrix(jcfg), jbath)
    ports = {}
    for route in routes:
        cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
            ed_fused_matvec=route)
        ports[route] = solve_impurity(
            cfg, hloc, build_umatrix(cfg),
            bath_from_array(j_bath_to_array(jbath), cfg), CPU)
    return jres, ports


def _assert_chi(jres, res, kinds, what):
    z = _nu(jres.cfg.beta)
    assert set(res.chi.channels) == set(jres.chi.channels), what
    for kind in kinds:
        want = jres.get_chi(kind, z)
        got = res.get_chi(kind, z)
        scale = np.abs(want).max()
        assert scale > 0, (what, kind)
        assert np.abs(got - want).max() / scale <= TOL["chi"], (what, kind)


@pytest.fixture(scope="module")
def finite_t(one_device):
    return _both(FINITE_T_MODEL, CRYSTAL)


@pytest.mark.parametrize("route", ["always", "never"])
def test_chi_all_kinds_vs_jax(finite_t, route):
    jres, ports = finite_t
    res = ports[route]
    w = res.diag.state_list.boltzmann_weights()
    assert len(w) == 3 and np.ptp(w) > 0.01
    assert abs(res.e0 - jres.e0) <= TOL["e0"]
    assert "susceptibilities" in res.timings
    _assert_chi(jres, res, ("spin", "dens", "pair", "exct_s", "exct_tz",
                            "exct_t"), route)
    # the exciton getter asks for the key "exct", which no channel has:
    # zeros in both packages
    z = _nu(jres.cfg.beta)
    assert np.array_equal(res.get_chi("exct", z), jres.get_chi("exct", z))
    # target sectors above lanc_dim_threshold ran Lanczos chains through
    # the route's operator; on the CPU the fused one never launches B1
    big = [i for i in range(len(res.table))
           if res.table.get_dim(i) > res.cfg.lanc_dim_threshold]
    assert big and res.n_matvecs > 0 and fm.launches == 0


def test_chi_phonons_vs_jax(one_device):
    """χ with phonons: build_fused_normal refuses phonon sectors, so every
    route runs KronMatvec."""
    from edipack_tpu_torch.solver.core import _normal_builders
    jres, ports = _both(PHONON_MODEL, np.zeros((1, 1, 1, 1)),
                        routes=("always",))
    res = ports["always"]
    b = _normal_builders(res.cfg, res.table, res.hloc, res.um, res.bath, CPU)
    sec = max(res.table, key=lambda s: s.dim)
    assert type(b.matvec_builder(sec)).__name__ == "KronMatvec"
    assert abs(res.e0 - jres.e0) <= TOL["e0"]
    _assert_chi(jres, res, ("spin", "dens", "pair"), "phonons")


@pytest.mark.parametrize("route", ["always", "never"])
def test_total_ud_false_vs_jax(one_device, route):
    """Per-orbital quantum numbers: the port's solve against the JAX
    package's, and build_fused_normal takes the per-orbital sector bases
    (route always runs the fused operator's plain version)."""
    from edipack_tpu_torch.solver.core import _normal_builders
    hloc = CRYSTAL
    jres, ports = _both(TOTAL_UD_MODEL, hloc, routes=(route,))
    res = ports[route]
    assert abs(res.e0 - jres.e0) <= TOL["e0"]
    for k in ("dens", "docc"):
        assert np.abs(getattr(res, k) - getattr(jres, k)).max() \
            <= TOL["obs"], k
    z = 1j * np.pi / res.cfg.beta * (2 * np.arange(NMATS) + 1)
    assert np.abs(res.get_gimp(z) - jres.get_gimp(z)).max() <= TOL["gf"]
    assert np.abs(res.rdm - jres.rdm).max() <= TOL["obs"]
    _assert_chi(jres, res, ("spin", "dens", "pair"), route)
    b = _normal_builders(res.cfg, res.table, hloc, res.um, res.bath, CPU)
    sec = max(res.table, key=lambda s: s.dim)
    assert len(sec.qn[1]) == 2          # per-orbital up counts
    want = "FusedKron" if route == "always" else "KronMatvec"
    assert type(b.matvec_builder(sec)).__name__ == want


def _write_chi_files(mod, cfg, outdir):
    """One ed_solve with ed_write_files through the ed_* API of ``mod``;
    returns the result."""
    os.makedirs(outdir, exist_ok=True)
    bath = mod.ed_init_solver(cfg=cfg, **({} if mod.__name__.startswith(
        "edipack_tpu.") else dict(device="cpu")))
    mod.ed_set_hloc(CRYSTAL)
    return mod.ed_solve(bath)


def test_chi_files_and_store_across_packages(one_device, tmp_path,
                                             monkeypatch):
    """The χ text files and chimatrix.npz: the same names, layout and
    number format in both packages, the values within 1e-8 relative except
    the ν_0 row of the Hermitian channels (see the module docstring), and
    each package reads the other's store."""
    import edipack_tpu.main as jed
    from edipack_tpu.config import set_config as j_set_config
    import edipack_tpu_torch.main as ted
    from edipack_tpu_torch.config import set_config
    monkeypatch.chdir(tmp_path)
    model = dict(norb=2, nbath=1, nspin=1, uloc=[1.5, 1.5], ust=0.7,
                 jh=0.1, xmu=0.3, beta=50.0, lmats=40, ed_write_files=True,
                 **CHI_FLAGS)
    jcfg = j_set_config(j_config(**model, ed_verbose=0,
                                 ed_output_dir=str(tmp_path / "jax")))
    jres = _write_chi_files(jed, jcfg, jcfg.ed_output_dir)
    cfg = set_config(config_from_jax(dataclasses.asdict(jcfg)).replace(
        ed_output_dir=str(tmp_path / "torch")))
    res = _write_chi_files(ted, cfg, cfg.ed_output_dir)
    names = sorted(f for f in os.listdir(tmp_path / "jax") if "Chi" in f)
    assert names and names == sorted(
        f for f in os.listdir(tmp_path / "torch") if "Chi" in f)
    assert {n.split("_l")[0] for n in names} == {
        "spinChi", "densChi", "pairChi", "exctChi_singlet",
        "exctChi_tripletXY", "exctChi_tripletZ"}
    for name in names:
        jl = (tmp_path / "jax" / name).read_text().splitlines()
        tl = (tmp_path / "torch" / name).read_text().splitlines()
        assert len(jl) == len(tl) == model["lmats"], name
        jv = np.array([[float(x) for x in ln.split()] for ln in jl])
        tv = np.array([[float(x) for x in ln.split()] for ln in tl])
        assert [ln.split()[0] for ln in jl] == [ln.split()[0] for ln in tl]
        for ln in tl:                   # "%.12f %.12e %.12e"
            x, im, re_ = ln.split()
            assert len(x.split(".")[1]) == 12 and "e" in im and "e" in re_
        scale = np.abs(jv[1:, 1:]).max()
        assert np.abs(tv[1:, 1:] - jv[1:, 1:]).max() / scale <= TOL["chi"]
        if not name.startswith(("spinChi", "densChi")):
            assert np.abs(tv[0, 1:] - jv[0, 1:]).max() / scale \
                <= TOL["chi"], name
    # the stores: the same arrays by name, and read across packages
    with np.load(tmp_path / "jax" / "chimatrix.npz") as a, \
            np.load(tmp_path / "torch" / "chimatrix.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    z = _nu(jcfg.beta)
    kinds = ("spin", "dens", "pair", "exct_s", "exct_tz", "exct_t")
    own = {k: (jres.get_chi(k, z), res.get_chi(k, z)) for k in kinds}
    for k, (want, got) in own.items():
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL["chi"]
    # each package takes the other's store in place of its own
    ted.ed_read_spinchimatrix(str(tmp_path / "jax" / "chimatrix.npz"))
    jed.ed_read_denschimatrix(str(tmp_path / "torch" / "chimatrix.npz"))
    for k, (j_own, t_own) in own.items():
        assert np.abs(res.get_chi(k, z) - j_own).max() \
            <= 1e-12 * np.abs(j_own).max(), k
        assert np.abs(jres.get_chi(k, z) - t_own).max() \
            <= 1e-12 * np.abs(t_own).max(), k
    assert ted.ed_get_spinchi(z).shape == (2, 2, NMATS)
    assert np.array_equal(ted.ed_build_pairchi(z), res.get_chi("pair", z))
    ted.ed_finalize_solver()
    jed.ed_finalize_solver()
