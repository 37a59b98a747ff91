"""The DMFT loop of edipack_tpu_torch against edipack_tpu's, on the CPU:
the Bethe-lattice loop through both packages' ed_* API, the ed_write_files
text outputs, restart files written by either package and read by the
other, the ed_sectors restricted sweep, the μ search, the bath symmetry
helpers and the convergence check. Every test works in its own tmp_path
(both packages read hamiltonian.restart from the working directory)."""
import json
import os

import numpy as np
import pytest
import torch

import edipack_tpu.bath.user as juser
import edipack_tpu.config as jconfig
import edipack_tpu.main as jed
import edipack_tpu.solver.mu_search as jmu
from edipack_tpu import io as jio
from edipack_tpu.sectors import SectorTable as JSectorTable
from edipack_tpu.solver.greens import GFMatrix as JGFMatrix

import edipack_tpu_torch.bath.user as tuser
import edipack_tpu_torch.config as tconfig
import edipack_tpu_torch.main as ted
import edipack_tpu_torch.solver.mu_search as tmu
from edipack_tpu_torch import io as tio
from edipack_tpu_torch.examples.hm_bethe import dmft_loop
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.solver.greens import GFMatrix
from gen_torch_golden import OUT_DMFT, dmft_loops

torch.set_num_threads(1)
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
# the 3-loop Bethe DMFT: norb=1, nbath=4, fits by L-BFGS-B (cg_method=1),
# which stops on its own criterion (tests/test_torch_fit.py)
BETHE = dict(norb=1, nbath=4, nspin=1, uloc=[2.0], beta=50.0, lmats=256,
             lfit=200, cg_scheme="delta", cg_method=1, cg_niter=300)
# Σ, G, densities and the fitted packed bath at every loop; measured gaps
# Σ 6.8e-13, G 7.2e-14, the bath 1.5e-14
LOOP_TOL = 1e-8
# text outputs: numbers printed with 12 digits (the solves agree to 1e-10)
FILE_TOL = 1e-8
# n2b4 DMFT golden: loop 1 as the solve goldens; the fitted baths and loop
# 2 at GOLDEN_TOL. The port's loops on the CPU (test_dmft_golden_n2b4_cpu)
# lie from the file's: loop 1 G 2.7e-10, Σ 7.5e-12, fitted bath 1.0e-11;
# loop 2 e0 3.5e-11, G 2.1e-10, Σ 2.6e-7 (its Σ = G0⁻¹ - G⁻¹ magnifies
# the error of a small G), fitted bath 1.4e-11. GOLDEN_TOL leaves about
# 40 times that room, for a card whose loop-1 G moves each fit's path
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, gimp=1e-8, sigma=1e-8)
GOLDEN_TOL = dict(e0=1e-7, dens=1e-7, docc=1e-7, gimp=1e-7, sigma=1e-5,
                  bath=1e-7)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Run in tmp_path with fresh global state in both packages, and
    edipack_tpu's solve on one device (the suite's virtual 8-device CPU
    mesh would only shard the dense buckets)."""
    import jax
    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.chdir(tmp_path)
    yield
    for mod in (jed, ted):
        mod.ed_finalize_solver()
        mod.ed_reset_convergence()
    jmu.reset_search()
    tmu.reset_search()
    jconfig.set_config(jconfig.EDConfig())
    tconfig.set_config(tconfig.EDConfig())


def _both(**kw):
    """The same configuration in both packages, installed as current."""
    return (jconfig.set_config(jconfig.default_config(ed_verbose=0, **kw)),
            tconfig.set_config(tconfig.default_config(ed_verbose=0, **kw)))


def test_bethe_loop_three_iterations():
    """Three Bethe-lattice DMFT loops through both ed_* APIs (solve, Δ =
    (D/2)² G, ed_chi2_fitgf): Σ, G, the densities and the fitted bath at
    every loop."""
    jcfg, cfg = _both(**BETHE)
    want = dmft_loops(jed, jcfg, 3)
    got = dmft_loops(ted, cfg, 3, device="cpu")
    for k, (g, w) in enumerate(zip(got, want)):
        assert abs(g["e0"] - w["e0"]) <= LOOP_TOL, k
        for key in ("dens", "docc", "gimp", "sigma", "bath"):
            assert np.abs(g[key] - w[key]).max() <= LOOP_TOL, (k, key)
    # the bath moved, and the loop with it
    assert np.abs(got[0]["bath"] - got[1]["bath"]).max() > 1e-3


@pytest.fixture
def written(tmp_path):
    """One ed_write_files solve of each package (norb=2, nbath=2, Kanamori,
    short grids) into its own directory."""
    dirs = {}
    for name, mod, cfgmod, init in (("jax", jed, jconfig, {}),
                                    ("torch", ted, tconfig,
                                     {"device": "cpu"})):
        out = tmp_path / name
        cfg = cfgmod.default_config(
            norb=2, nbath=2, nspin=1, ed_verbose=0, ed_write_files=True,
            ed_output_dir=str(out), lmats=64, lreal=100, ltau=50,
            hfile=str(out / "hamiltonian"), **KANAMORI)
        mod.ed_init_solver(cfg=cfg, **init)
        mod.ed_set_hloc(np.diag([0.1, -0.1])[None, None])
        res = mod.ed_solve()
        dirs[name] = (out, cfg, res.e0, len(res.diag.evals_by_sector))
        mod.ed_finalize_solver()
    return dirs


def _tokens(path):
    with open(path) as fh:
        return [line.split() for line in fh]


def test_write_files_agree(written):
    """Every file edipack_tpu writes, the port writes under the same name,
    with the same columns and numbers (text) or channels (npz)."""
    jdir, tdir = written["jax"][0], written["torch"][0]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for want in ("observables_last.ed", "energy_last.ed", "state_list.ed",
                 "eigenvalues_list.ed", "impG_l11_s1_iw.ed",
                 "impSigma_l22_s1_realw.ed", "impG_l11_s1_tau.ed",
                 "impG0_l11_s1_iw.ed", "state_list.restart",
                 "sectors.restart", "hamiltonian.used", "gfmatrix.npz"):
        assert want in names, want
    z = 1j * np.linspace(0.1, 3.0, 9)
    for name in names:
        if name.endswith(".npz"):
            jg, tg = JGFMatrix.load(str(jdir / name)), \
                GFMatrix.load(str(tdir / name))
            assert sorted(jg.channels) == sorted(tg.channels)
            for key in jg.channels:
                assert np.abs(jg.eval(key, z) - tg.eval(key, z)).max() \
                    <= FILE_TOL
            continue
        jt, tt = _tokens(jdir / name), _tokens(tdir / name)
        assert len(jt) == len(tt), name
        for jl, tl in zip(jt, tt):
            assert len(jl) == len(tl), name
            for a, b in zip(jl, tl):
                try:
                    x, y = float(a), float(b)
                except ValueError:
                    assert a == b, name
                    continue
                assert abs(x - y) <= FILE_TOL, (name, a, b)
    # observables_last.ed carries the densities
    vals = np.loadtxt(tdir / "observables_last.ed")
    assert written["torch"][2] == pytest.approx(written["jax"][2], abs=1e-10)
    assert vals[:2].sum() > 0


def test_restart_files_cross_read(written):
    """state_list, sectors, bath and xmu restart files written by either
    package are read by the other as by their writer."""
    jdir, jcfg = written["jax"][:2]
    tdir, cfg = written["torch"][:2]
    jtab, ttab = JSectorTable(jcfg), SectorTable(cfg)
    for d in (jdir, tdir):
        sl = str(d / "state_list.restart")
        se = str(d / "sectors.restart")
        want = jio.read_state_list_restart(jcfg, jtab, sl)
        assert want is not None
        assert np.array_equal(tio.read_state_list_restart(cfg, ttab, sl),
                              want)
        mask = jio.read_sectors_restart(jcfg, jtab, se)
        assert np.array_equal(tio.read_sectors_restart(cfg, ttab, se), mask)
        assert 0 < mask.sum() < len(mask)
    # the packed bath: written by one, adopted by the other's ed_init_solver
    hfile = str(tdir.parent / "shared")
    jcfg, cfg = jcfg.replace(hfile=hfile), cfg.replace(hfile=hfile)
    arr = jed.ed_init_solver(cfg=jcfg)
    arr = arr + np.random.default_rng(2).normal(scale=0.1, size=arr.shape)
    jconfig.set_config(jcfg)
    juser.ed_save_array_as_bath(arr)
    assert np.array_equal(ted.ed_init_solver(cfg=cfg, device="cpu"), arr)
    assert np.array_equal(tuser.ed_read_dmft_bath(cfg=cfg), arr)
    tconfig.set_config(cfg)
    tuser.ed_save_array_as_bath(arr[::-1].copy())
    assert np.array_equal(jed.ed_init_solver(cfg=jcfg), arr[::-1])
    # xmu.restart
    shared = str(tdir.parent)
    jcfg, cfg = jcfg.replace(ed_output_dir=shared), \
        cfg.replace(ed_output_dir=shared)
    tio.write_xmu_restart(cfg, 0.37, 0.05)
    assert jio.read_xmu_restart(jcfg) == tio.read_xmu_restart(cfg)
    jio.write_xmu_restart(jcfg, -0.2, 0.125)
    assert tio.read_xmu_restart(cfg) == (-0.2, 0.125)


def test_ed_sectors_restricted_sweep(written):
    """ed_sectors=True restricts the sweep to the sectors.restart sectors
    (± ed_sectors_shift) and finds the same ground state, as edipack_tpu's
    (tests/test_io_restart.py)."""
    e0, nsec = {}, {}
    for name, mod, init in (("jax", jed, {}), ("torch", ted,
                                               {"device": "cpu"})):
        _, cfg, e0_full, nsec_full = written[name]
        cfg = cfg.replace(ed_sectors=True, ed_write_files=False)
        mod.ed_init_solver(cfg=cfg, **init)
        mod.ed_set_hloc(np.diag([0.1, -0.1])[None, None])
        res = mod.ed_solve()
        assert abs(res.e0 - e0_full) <= 1e-10
        nsec[name] = sorted(res.diag.evals_by_sector)
        assert len(nsec[name]) < nsec_full
        e0[name] = res.e0
        mod.ed_finalize_solver()
    assert nsec["torch"] == nsec["jax"]
    assert abs(e0["torch"] - e0["jax"]) <= 1e-10


def test_gfmatrix_store(written):
    """ed_read_impgmatrix reloads the store a solve wrote, from either
    package: ed_build_impg and ed_build_sigma then give the solve's G and
    Σ on any grid."""
    cfg = written["torch"][1]
    tconfig.set_config(cfg)
    ted.ed_init_solver(cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.diag([0.1, -0.1])[None, None])
    ted.ed_solve()
    z = 1j * np.linspace(0.05, 2.0, 7)
    g, s = ted.ed_build_impg(z), ted.ed_build_sigma(z)
    for d in (written["jax"][0], written["torch"][0]):
        gf = ted.ed_read_impgmatrix(str(d / "gfmatrix.npz"))
        assert gf.channels
        assert np.abs(ted.ed_build_impg(z) - g).max() <= FILE_TOL
        assert np.abs(ted.ed_build_sigma(z) - s).max() <= FILE_TOL
    # the default path: ed_output_dir / gfmatrix<suffix>.npz
    assert ted.ed_read_impgmatrix().channels


def test_g0and_and_delta_of_a_given_bath():
    """ed_get_g0and / ed_get_delta with an explicit packed bath (the current
    config's layout) against edipack_tpu's."""
    jcfg, cfg = _both(norb=2, nbath=3, nspin=1, xmu=0.2, **KANAMORI)
    hloc = np.diag([0.15, -0.05])[None, None]
    arr = jed.ed_init_solver(cfg=jcfg)
    jed.ed_set_hloc(hloc)
    ted.ed_init_solver(cfg=cfg, device="cpu")
    ted.ed_set_hloc(hloc)
    arr = arr + np.random.default_rng(4).normal(scale=0.1, size=arr.shape)
    z = 1j * np.linspace(0.1, 4.0, 11)
    assert np.abs(ted.ed_get_g0and(z, arr) - jed.ed_get_g0and(z, arr)).max() \
        <= 1e-13
    assert np.abs(ted.ed_get_delta(z, arr) - jed.ed_get_delta(z, arr)).max() \
        <= 1e-13


def test_mu_search_follows_jax(tmp_path):
    """ed_search_chemical_potential over a scripted density series: the same
    xmu sequence, convergence flags, xmu.restart and search log."""
    seq = {}
    for name, mod, cfgmod in (("jax", jed, jconfig), ("torch", ted, tconfig)):
        out = tmp_path / name
        out.mkdir()
        cfgmod.set_config(cfgmod.default_config(
            nread=1.5, ndelta=0.2, nerr=1e-4, cg_niter=40,
            ed_output_dir=str(out)))
        xmu, steps = 0.0, []
        for _ in range(60):
            dens = 1.5 + 0.8 * np.tanh(xmu - 0.37)
            xmu, conv = mod.ed_search_chemical_potential(xmu, dens, True)
            steps.append((xmu, conv))
        seq[name] = steps
        assert sorted(os.listdir(out)) == ["search_mu_iteration.ed",
                                           "xmu.restart"]
    assert seq["torch"] == seq["jax"]
    assert seq["jax"][-1][1] and abs(seq["jax"][-1][0] - 0.37) < 1e-3
    for f in ("search_mu_iteration.ed", "xmu.restart"):
        assert (tmp_path / "jax" / f).read_text() \
            == (tmp_path / "torch" / f).read_text()
    # a new search adopts xmu.restart's step; the start point as well
    jmu.reset_search()
    tmu.reset_search()
    assert tmu.read_xmu_start(tconfig.get_config()) \
        == jmu.read_xmu_start(jconfig.get_config())


BATH_OPS = {
    "spin_symmetrize": (dict(nspin=2), "ed_spin_symmetrize_bath", {}),
    "orb_symmetrize": (dict(norb=2), "ed_orb_symmetrize_bath", {}),
    "orb_symmetrize_pair": (dict(norb=3), "ed_orb_symmetrize_bath",
                            dict(orb1=1, orb2=3)),
    "orb_equality": (dict(norb=3), "ed_orb_equality_bath", dict(indx=2)),
    "break_symmetry": (dict(nspin=2), "ed_break_symmetry_bath",
                       dict(field=0.1, sign=-1.0)),
    "ph_symmetrize_odd": (dict(nbath=5), "ed_ph_symmetrize_bath", {}),
    "ph_symmetrize_hybrid": (dict(norb=2, bath_type="hybrid"),
                             "ed_ph_symmetrize_bath", {}),
    "enforce_normal_superc": (dict(ed_mode="superc"),
                              "ed_enforce_normal_bath", {}),
    "ph_trans_norb1": (dict(), "ed_ph_trans_bath", {}),
    "ph_trans_norb2": (dict(norb=2), "ed_ph_trans_bath", {}),
}


@pytest.mark.parametrize("op", list(BATH_OPS))
def test_bath_helper(op):
    """Each bath/user.py operation on a random packed bath against
    edipack_tpu's, and its save/read round trip."""
    kw, fname, args = BATH_OPS[op]
    jcfg, cfg = _both(**dict(dict(norb=1, nbath=4, nspin=1), **kw))
    arr = jed.ed_get_bath_dimension(jcfg)
    assert ted.ed_get_bath_dimension(cfg) == arr
    arr = np.random.default_rng(9).normal(size=arr)
    want = getattr(juser, fname)(arr, cfg=jcfg, **args)
    got = getattr(tuser, fname)(arr, cfg=cfg, **args)
    assert np.array_equal(got, want)
    assert not np.array_equal(got, arr) or op == "enforce_normal_superc"
    tuser.ed_save_array_as_bath(got, cfg=cfg)
    assert np.array_equal(juser.ed_read_dmft_bath(cfg=jcfg), got)


def test_check_convergence_follows_jax():
    """ed_check_convergence over a converging series: the same errors and
    flags (nsuccess=2), and a reset starts over."""
    _both(dmft_error=1e-3, nsuccess=2)
    rng = np.random.default_rng(1)
    f = rng.normal(size=(1, 1, 1, 1, 16)) + 1j
    for k in range(8):
        g = f * (1 + 0.1 ** k)
        assert ted.ed_check_convergence(g) == jed.ed_check_convergence(g)
    assert ted.ed_check_convergence(f)[1]
    ted.ed_reset_convergence()
    assert ted.ed_check_convergence(f) == (1.0, False)
    assert ted.ed_check_convergence(f, threshold=1e-12, nsuccess=1) \
        == (0.0, True)


def _jax_example_loop(cfg, perturb=0.0):
    """examples/python/hm_bethe.py's loop through edipack_tpu's API, with
    the fit target scaled by (1 + perturb). Returns Σ per loop."""
    jconfig.set_config(cfg)
    bath = jed.ed_init_solver(cfg=cfg)
    jed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    sigmas, delta_prev = [], None
    for _ in range(cfg.nloop):
        jed.ed_solve(bath)
        delta = 0.25 * jed.ed_get_gimp(axis="m")
        if delta_prev is not None:
            delta = 0.5 * delta + 0.5 * delta_prev
        err = (1.0 if delta_prev is None else
               float(np.sum(np.abs(delta - delta_prev))
                     / max(np.sum(np.abs(delta)), 1e-15)))
        sigmas.append(jed.ed_get_sigma(axis="m"))
        delta_prev = delta
        if err < cfg.dmft_error:
            break
        bath = jed.ed_chi2_fitgf(delta[0, 0][..., :cfg.lfit] * (1 + perturb),
                                 bath, ispin=1)
    jed.ed_finalize_solver()
    return sigmas


@pytest.mark.slow
def test_hm_bethe_example_vs_jax():
    """The port's hm_bethe loop at examples/python/inputED.conf (U = 2D,
    nbath=5) to convergence, against the JAX example's loop. Its fits are
    the default CG, stopped at cg_niter, so each loop's Σ moves with the
    last bits of the fit's target (tests/test_torch_fit.py), and the loop
    carries that on: JAX's own loop, with every fit target scaled by
    1 ± 1e-12, moves by up to 0.3 in Σ (|Σ| 2.6) at loop 3 and by 2e-5 to
    3e-4 over the last ten loops. Σ at every loop is held to JAX's within
    10 times the larger of those two moves (the port's gap measured: at
    most 3.3 times it), and the loop converges within one loop of JAX's."""
    conf = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples", "python", "inputED.conf")
    kw = tconfig.parse_input_file(conf)
    jcfg = jconfig.default_config(**kw)
    want = _jax_example_loop(jcfg)
    shaken = [_jax_example_loop(jcfg, perturb=p) for p in (1e-12, -1e-12)]
    got = [r["sigma"] for r in dmft_loop(tconfig.default_config(**kw), "cpu",
                                         log=lambda s: None)]
    assert 15 <= len(got) < jcfg.nloop
    assert abs(len(got) - len(want)) <= 1
    n = min(len(got), len(want), *(len(s) for s in shaken))
    for k in range(n):
        spread = max(np.abs(s[k] - want[k]).max() for s in shaken)
        gap = np.abs(got[k] - want[k]).max()
        print(f"loop {k + 1}: |Σ| {np.abs(want[k]).max():.2e}, port gap "
              f"{gap:.2e}, JAX's own spread {spread:.2e}")
        assert gap <= max(LOOP_TOL, 10 * spread), (k, gap, spread)


def _golden_run(device):
    """The n2b4 DMFT golden's loops through the port, held to the file."""
    with open(OUT_DMFT) as fh:
        gold = json.load(fh)
    cfg = tconfig.set_config(tconfig.default_config(
        **gold["config"], ed_verbose=0, ed_fused_matvec="always"))
    got = dmft_loops(ted, cfg, len(gold["loops"]), device=device)
    cplx = lambda a: np.asarray(a)[..., 0] + 1j * np.asarray(a)[..., 1]
    gaps = []
    for k, (g, w) in enumerate(zip(got, gold["loops"])):
        gap = {key: float(np.abs(np.asarray(g[key]) - (
            cplx(w[key]) if key in ("gimp", "sigma") else np.asarray(w[key])
        )).max()) for key in ("e0", "dens", "docc", "gimp", "sigma", "bath")}
        tol = dict(TOL if k == 0 else GOLDEN_TOL, bath=GOLDEN_TOL["bath"])
        for key, val in gap.items():
            assert val <= tol[key], (k, key, val)
        gaps.append(gap)
    return gaps


@pytest.mark.slow
def test_dmft_golden_n2b4_cpu():
    """norb=2, nbath=4: two Bethe DMFT loops on the CPU (the fused
    operator's plain version) against tests/data/torch_port_golden_dmft_
    n2b4.json. Loop 1 at the solve goldens' tolerances; the fitted baths
    and loop 2 at GOLDEN_TOL, which leaves room for the card's loop-1 G
    (2.5e-10 from JAX's on the solve golden) moving the fit."""
    print(_golden_run("cpu"))


@pytest.mark.cuda
def test_dmft_golden_n2b4_on_card():
    """The same two loops on the card, through B1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    print(_golden_run("cuda"))
