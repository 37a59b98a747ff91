"""Inequivalent impurities on the port: the site-batched sweep
(solve_impurity_sites) and EDIneqSolver of edipack_tpu_torch on the CPU,
against edipack_tpu on the same numpy-seeded inputs and against the port's
own one-site solves, at the tolerances of tests/test_ineq_parallel.py (e0
1e-10, dens/docc 1e-9, G 1e-8; fitted baths 1e-7). ``lanc_dim_threshold``
is lowered so that Lanczos sectors run across the sites."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import edipack_tpu.config as jconfig
import edipack_tpu.bath.user as juser
from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.ineq import EDIneqSolver as JIneq
from edipack_tpu.solver.core import solve_impurity_sites as j_sites
from edipack_tpu.umatrix import build_umatrix as j_umatrix

import edipack_tpu_torch as ted
import edipack_tpu_torch.config as tconfig
from edipack_tpu_torch import io as tio
from edipack_tpu_torch.bath.dmft_bath import bath_to_array
from edipack_tpu_torch.convert import (baths_from_stack, config_from_jax,
                                       read_lattice_baths)
from edipack_tpu_torch.ops import fused_matvec as fm
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.solver.core import solve_impurity, solve_impurity_sites
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
TOL = dict(e0=1e-10, dens=1e-9, docc=1e-9, gimp=1e-8, bath=1e-7)
FILE_TOL = 1e-8           # text outputs print 13 significant digits
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
# the Lanczos sectors: n1b3 (2,2) 36, (1,2)/(2,1)/(2,3)/(3,2) 24; n2b2
# (3,3) 400 (a lower threshold adds sector shapes, each a JAX compile)
CONFIGS = {
    "n1b3": dict(norb=1, nbath=3, nspin=1, beta=60.0, uloc=[2.0], xmu=1.0,
                 lmats=24, lanc_dim_threshold=16),
    "n2b2": dict(norb=2, nbath=2, nspin=1, beta=40.0, xmu=0.3, lmats=24,
                 lanc_dim_threshold=350, **KANAMORI),
}
NSITES = 3
ZETA = 1j * (2 * np.arange(8) + 1) * np.pi / 40.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Run in tmp_path with fresh global state, and edipack_tpu's sweep on
    one device (the suite's virtual 8-device CPU mesh would only shard the
    dense buckets)."""
    import jax
    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.chdir(tmp_path)
    yield
    jconfig.set_config(jconfig.EDConfig())
    tconfig.set_config(tconfig.EDConfig())


def _sites(name):
    """Per-site configs (U and xmu differ), staggered Hlocs and baths made
    from one numpy seed, in edipack_tpu's types."""
    base = jconfig.default_config(ed_verbose=0, **CONFIGS[name])
    rng = np.random.default_rng(7)
    cfgs, hlocs, baths = [], [], []
    norb = base.norb
    for s in range(NSITES):
        u = [x * (1.0 + 0.2 * (s - 1)) for x in base.uloc[:norb]]
        cfgs.append(base.replace(uloc=u, xmu=base.xmu + 0.05 * s))
        h = np.zeros((1, 1, norb, norb), complex)
        h[0, 0] = np.diag(np.full(norb, 0.15 * (s - 1)))
        hlocs.append(h)
        arr = j_bath_to_array(j_init_bath(cfgs[-1]))
        baths.append(arr + rng.normal(scale=0.05, size=arr.shape))
    return base, cfgs, hlocs, baths


_JAX_SWEEPS = {}


def _jax_sweep(name):
    """edipack_tpu's sweep of _sites(name), once per module."""
    from edipack_tpu.bath.dmft_bath import array_to_bath as j_array_to_bath
    if name not in _JAX_SWEEPS:
        base, jcfgs, hlocs, arrs = _sites(name)
        _JAX_SWEEPS[name] = j_sites(
            base, hlocs, [j_umatrix(c) for c in jcfgs],
            [j_array_to_bath(a, c) for a, c in zip(arrs, jcfgs)], cfgs=jcfgs)
    return _JAX_SWEEPS[name]


def _close(got, want, tol, what):
    dev = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert dev <= tol, f"{what}: {dev:.3e} > {tol}"


def _hold(res, ref, what):
    _close(res.e0, ref.e0, TOL["e0"], what + " e0")
    _close(res.dens, ref.dens, TOL["dens"], what + " dens")
    _close(res.docc, ref.docc, TOL["docc"], what + " docc")
    _close(res.get_gimp(ZETA), ref.get_gimp(ZETA), TOL["gimp"], what + " G")


@pytest.mark.parametrize("name, route", [("n1b3", "auto"),
                                         ("n2b2", "auto"),
                                         ("n2b2", "always")])
def test_sites_match_jax_and_lone_solves(name, route, monkeypatch):
    """The sweep against edipack_tpu's sweep and against the port's lone
    solve of each site; ``always`` takes B1's plain version on the CPU."""
    base, jcfgs, hlocs, arrs = _sites(name)
    want = _jax_sweep(name)
    cfg = config_from_jax(dataclasses.asdict(base)).replace(
        ed_fused_matvec=route)
    cfgs = [config_from_jax(dataclasses.asdict(c)).replace(
        ed_fused_matvec=route) for c in jcfgs]
    baths = [baths_from_stack(a, c)[0] for a, c in zip(arrs, cfgs)]
    ums = [build_umatrix(c) for c in cfgs]
    plain = []
    orig = fm.fused_matvec_plain
    monkeypatch.setattr(fm, "fused_matvec_plain",
                        lambda *a: plain.append(1) or orig(*a))
    cpu = torch.device("cpu")
    got = solve_impurity_sites(cfg, hlocs, ums, baths, cpu, cfgs=cfgs)
    assert (len(plain) > 0) == (route == "always")
    ntab = SectorTable(cfg)
    assert any(ntab.get_dim(i) > cfg.lanc_dim_threshold
               for i in range(len(ntab)))
    for s in range(NSITES):
        _hold(got[s], want[s], f"{name} site {s} vs edipack_tpu")
        lone = solve_impurity(cfgs[s], hlocs[s], ums[s], baths[s], cpu)
        _hold(got[s], lone, f"{name} site {s} vs its lone solve")
        assert np.array_equal(got[s].neigen_sector, lone.neigen_sector)
        assert got[s].n_matvecs == lone.n_matvecs
        assert "diagonalization" in got[s].timings
        assert "greens_functions" in got[s].timings
    # the sites differ
    assert abs(got[0].e0 - got[2].e0) > 1e-3


def test_sites_must_share_the_structure():
    base, jcfgs, hlocs, arrs = _sites("n1b3")
    cfg = config_from_jax(dataclasses.asdict(base))
    cfgs = [cfg, cfg.replace(nbath=2), cfg]
    baths = [baths_from_stack(a, cfg)[0] for a in arrs]
    with pytest.raises(ValueError, match="sector structure"):
        solve_impurity_sites(cfg, hlocs, [build_umatrix(c) for c in cfgs],
                             baths, torch.device("cpu"), cfgs=cfgs)


def _lattice(mod, ineq_cls, cfg, outdir, **init):
    """The lattice driver both packages run: a per-site (5-d) Hloc, U
    overrides, a statics-only call, a full call, the stacked getters, the
    L-BFGS-B fit of every site to its Bethe Δ, and a second solve from the
    fitted baths with the 3-d Hloc shape. The files hold the full call:
    the second solve writes none, since its real-axis G magnifies the
    fits' last digits."""
    cfg = cfg.replace(ed_output_dir=str(outdir), hfile=str(outdir / "hamil"))
    mod.set_config(cfg)
    solver = ineq_cls(NSITES, cfg, **init)
    baths = solver.init_solver()
    hloc = np.zeros((NSITES, 1, 1, cfg.norb, cfg.norb))
    for s in range(NSITES):
        hloc[s, 0, 0] = np.diag(np.full(cfg.norb, 0.1 * (s - 1)))
    solver.set_hloc(hloc)
    uloc = np.array([[2.0 + 0.3 * s] * cfg.norb for s in range(NSITES)])
    ust = np.array([1.0, 1.1, 1.2])
    solver.solve(baths, uloc_ii=uloc, ust_ii=ust, flag_gf=False)
    out = dict(dens0=solver.get_dens(),
               g_off=solver.get_gimp(np.array([1j])))
    solver.solve(baths, uloc_ii=uloc, ust_ii=ust)
    out.update(dens=solver.get_dens(), docc=solver.get_docc(),
               magz=solver.get_mag("z"), eimp=solver.get_eimp(),
               doubles=solver.get_doubles(),
               neigen=solver.get_neigen_sector(),
               evals=np.concatenate(solver.get_evals()),
               gimp=solver.get_gimp(), sigma=solver.get_sigma(),
               g0imp=solver.get_g0imp(), sp_dm=solver.get_sp_dm(),
               e0=np.array([s.result.e0 for s in solver.solvers]))
    delta = 0.25 * solver.get_gimp()
    out["fit"] = solver.fit_gf(delta, baths)
    for site in solver.solvers:
        site.cfg = site.cfg.replace(ed_write_files=False)
    solver.set_hloc(hloc[:, 0, 0])
    solver.solve(out["fit"])
    out.update(e0_2=np.array([s.result.e0 for s in solver.solvers]),
               gimp_2=solver.get_gimp(), dens_2=solver.get_dens())
    return out


def test_ineq_solver_against_jax(tmp_path):
    """EDIneqSolver end to end in both packages: getters, per-site file
    names and numbers, fit_gf and the second iteration."""
    kw = dict(CONFIGS["n1b3"], ed_verbose=0, ed_write_files=True,
              cg_scheme="delta", cg_method=1, lfit=24)
    jcfg = jconfig.default_config(**kw)
    want = _lattice(jconfig, JIneq, jcfg, tmp_path / "jax")
    got = _lattice(tconfig, ted.EDIneqSolver, tconfig.default_config(**kw),
                   tmp_path / "torch", device="cpu")
    assert got["dens"].shape == (NSITES, 1)
    assert got["gimp"].shape == (NSITES, 1, 1, 1, 1, kw["lmats"])
    assert np.allclose(got["g_off"], 0.0)
    for key, tol in (("e0", TOL["e0"]), ("e0_2", TOL["e0"]),
                     ("evals", TOL["e0"]), ("dens0", TOL["dens"]),
                     ("dens", TOL["dens"]), ("docc", TOL["docc"]),
                     ("magz", TOL["dens"]), ("eimp", TOL["dens"]),
                     ("doubles", TOL["dens"]), ("sp_dm", TOL["dens"]),
                     ("gimp", TOL["gimp"]), ("sigma", TOL["gimp"]),
                     ("g0imp", TOL["gimp"]), ("fit", TOL["bath"]),
                     ("gimp_2", TOL["gimp"]), ("dens_2", TOL["dens"])):
        assert np.shape(got[key]) == np.shape(want[key]), key
        _close(got[key], want[key], tol, key)
    assert np.array_equal(got["neigen"], want["neigen"])
    # the staggered Hloc orders the sites' densities
    assert got["dens"][0, 0] > got["dens"][2, 0]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for s in range(NSITES):
        for stem in ("observables_last", "state_list", "impG_l11_s1_iw"):
            assert f"{stem}_ineq{s + 1:04d}.ed" in names
    for name in names:
        if not name.endswith(".ed"):
            continue
        with open(jdir / name) as fa, open(tdir / name) as fb:
            ja, tb = fa.read().split(), fb.read().split()
        assert len(ja) == len(tb), name
        for a, b in zip(ja, tb):
            try:
                x, y = float(a), float(b)
                assert abs(x - y) <= FILE_TOL * max(1.0, abs(y)), (name, a, b)
            except ValueError:
                assert a == b, name


def test_ineq_superc_pair_per_site_loop(monkeypatch):
    """Two superc sites go through EDSolver.solve one after another, in
    both packages."""
    import edipack_tpu_torch.solver.core as tcore
    kw = dict(norb=1, nbath=2, nspin=1, ed_mode="superc", beta=40.0,
              uloc=[2.0], xmu=0.0, lmats=16, ed_verbose=0)
    jcfg, cfg = jconfig.default_config(**kw), tconfig.default_config(**kw)
    hloc = np.zeros((2, 1, 1, 1, 1))
    hloc[0, 0, 0, 0, 0], hloc[1, 0, 0, 0, 0] = -0.1, 0.1
    out = []
    for solver in (JIneq(2, jcfg), ted.EDIneqSolver(2, cfg, device="cpu")):
        baths = solver.init_solver()
        solver.set_hloc(hloc)
        if isinstance(solver, ted.EDIneqSolver):
            monkeypatch.setattr(tcore, "solve_impurity_sites", None)
        solver.solve(baths, uloc_ii=np.array([[2.0], [3.0]]))
        out.append(dict(e0=[s.result.e0 for s in solver.solvers],
                        dens=solver.get_dens(), docc=solver.get_docc(),
                        phi=solver.get_phi(),
                        gimp=solver.get_gimp(ZETA),
                        impf=solver.get_gimp(ZETA, typ="a")))
    want, got = out
    for key in want:
        tol = TOL["e0"] if key == "e0" else TOL["gimp"]
        _close(got[key], want[key], tol, "superc " + key)
    assert np.abs(got["phi"]).min() > 1e-4    # the default bath pairs


def test_lattice_restart_carry_over(tmp_path):
    """A lattice edipack_tpu wrote (each site's bath through
    ed_save_array_as_bath under its _ineq suffix, and its state_list
    restart from an ed_write_files sweep) is read by the port unchanged."""
    kw = dict(CONFIGS["n1b3"], ed_verbose=0, hfile=str(tmp_path / "hamil"),
              ed_output_dir=str(tmp_path), ed_write_files=True)
    jcfg = jconfig.default_config(**kw)
    jsolver = JIneq(NSITES, jcfg)
    stack = jsolver.init_solver()
    stack = stack + np.random.default_rng(3).normal(scale=0.05,
                                                    size=stack.shape)
    for s in range(NSITES):
        juser.ed_save_array_as_bath(
            stack[s], cfg=jcfg.replace(ed_file_suffix=f"_ineq{s + 1:04d}"))
    jsolver.set_hloc(np.zeros((1, 1, 1, 1)))
    jsolver.solve(stack)
    cfg = tconfig.default_config(**kw)
    assert np.array_equal(read_lattice_baths(cfg, NSITES), stack)
    solver = ted.EDIneqSolver(NSITES, cfg, device="cpu")
    assert np.array_equal(solver.init_solver(), stack)
    from edipack_tpu import io as jio
    from edipack_tpu.sectors import SectorTable as JSectorTable
    table, jtable = SectorTable(cfg), JSectorTable(jcfg)
    for s, site in enumerate(solver.solvers):
        want = jio.read_state_list_restart(jsolver.solvers[s].cfg, jtable)
        assert want is not None
        assert site.cfg.ed_file_suffix == f"_ineq{s + 1:04d}"
        assert np.array_equal(tio.read_state_list_restart(site.cfg, table),
                              want)
        got = baths_from_stack(stack, cfg)[s]
        assert np.array_equal(bath_to_array(got), stack[s])
    with pytest.raises(FileNotFoundError):
        read_lattice_baths(cfg, NSITES + 1)
