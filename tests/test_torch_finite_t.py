"""Finite temperature (ed_finite_temp) in edipack_tpu_torch against
edipack_tpu on the CPU, through the fused operator's plain version (route
``always``) and KronMatvec (``never``); mirrors tests/test_finite_temp.py.

Thermal observables and G at 1e-8, e0 at 1e-10, the partition function
zeta at 1e-10 relative; the annealed budgets (lanc_nstates_total) and
neigen_sector exactly, solve by solve, as they are carried from one
ed_solve to the next; histogram_states.ed as text.
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
from edipack_tpu_torch.solver.core import solve_impurity
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
TOL = dict(e0=1e-10, obs=1e-8, gf=1e-8, zeta=1e-10)
CPU = torch.device("cpu")
# tests/test_finite_temp.py's models
THERMAL = dict(norb=1, nbath=2, nspin=1, uloc=[2.0], xmu=0.25, beta=4.0,
               ed_finite_temp=True, lanc_nstates_total=60,
               lanc_nstates_sector=12, cutoff=1e-10)
PHONON = dict(norb=2, nbath=1, nspin=1, uloc=[1.8, 1.5], ust=0.7, xmu=0.4,
              beta=5.0, ed_finite_temp=True, lanc_nstates_total=250,
              lanc_nstates_sector=20, cutoff=1e-10, nph=2, w0_ph=0.6,
              g_ph=[0.25, 0.2])
ANNEAL = dict(norb=1, nbath=3, nspin=1, uloc=[2.0], xmu=0.3, beta=3.0,
              ed_finite_temp=True, lanc_nstates_total=12,
              lanc_nstates_sector=3, lanc_nstates_step=4, cutoff=1e-3,
              lanc_dim_threshold=12)
NSOLVES = 4


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


def _assert_thermal(res, jres, nz, what):
    assert abs(res.e0 - jres.e0) <= TOL["e0"], what
    assert abs(res.diag.zeta / jres.diag.zeta - 1) <= TOL["zeta"], what
    assert len(res.diag.state_list) == len(jres.diag.state_list), what
    assert res.diag.lanc_nstates_total == jres.diag.lanc_nstates_total
    assert np.array_equal(res.diag.neigen_sector, jres.diag.neigen_sector)
    for k in ("dens", "docc", "energies"):
        assert np.abs(getattr(res, k) - getattr(jres, k)).max() \
            <= TOL["obs"], (what, k)
    z = 1j * np.pi / res.cfg.beta * (2 * np.arange(nz) + 1)
    assert np.abs(res.get_gimp(z) - jres.get_gimp(z)).max() <= TOL["gf"]


@pytest.mark.parametrize("model,hloc", [
    (THERMAL, np.zeros((1, 1, 1, 1))),
    (PHONON, np.array([[0.1, 0.07], [0.07, -0.1]]).reshape(1, 1, 2, 2)),
], ids=["norb1", "norb2_phonons"])
def test_finite_t_solve_vs_jax(one_device, model, hloc):
    jcfg = j_config(**model, ed_verbose=0)
    jbath = j_init_bath(jcfg)
    jres = j_solve(jcfg, hloc, j_umatrix(jcfg), jbath)
    for route in ("always", "never"):
        cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
            ed_fused_matvec=route)
        res = solve_impurity(cfg, hloc, build_umatrix(cfg),
                             bath_from_array(j_bath_to_array(jbath), cfg),
                             CPU)
        _assert_thermal(res, jres, 24, route)
        # a thermal list, not the ground multiplet: budget and weights
        assert len(res.diag.state_list) > 4
        if cfg.nph:
            assert abs(res.obs.ph_x - jres.obs.ph_x) <= TOL["obs"]
            assert abs(res.obs.ph_x2 - jres.obs.ph_x2) <= TOL["obs"]


def _sequence(mod, cfg, outdir, **init):
    """NSOLVES ed_solve calls of one solver with ed_write_files on; per
    solve the budget it took, what it returned, and the histogram file."""
    cfg = cfg.replace(ed_write_files=True, ed_output_dir=str(outdir))
    s = mod.EDSolver(cfg, **init)
    s.init_solver()
    s.set_hloc(np.zeros((1, 1, 1, 1)))
    out = []
    for _ in range(NSOLVES):
        res = s.solve(flag_gf=True)
        out.append((res.cfg.lanc_nstates_total, res))
    return s, out, (outdir / "histogram_states.ed").read_text()


@pytest.fixture(scope="module")
def jax_anneal(one_device, tmp_path_factory):
    """edipack_tpu's annealing sequence, run once for both routes."""
    import edipack_tpu.main as jmain
    from edipack_tpu.config import set_config as j_set_config
    out = tmp_path_factory.mktemp("anneal_jax")
    old = os.getcwd()
    os.chdir(out)
    try:
        jcfg = j_set_config(j_config(**ANNEAL, ed_verbose=0))
        return (jcfg,) + _sequence(jmain, jcfg, out)
    finally:
        os.chdir(old)


@pytest.mark.parametrize("route", ["always", "never"])
def test_finite_t_annealing_vs_jax(jax_anneal, tmp_path, monkeypatch,
                                   route):
    """tests/test_finite_temp.py::test_finite_t_annealing_multi_solve in
    both packages: the per-sector neigen and the lanc_nstates_total
    feedback carried between ed_solve calls of one solver."""
    import edipack_tpu_torch.main as tmain
    from edipack_tpu_torch.config import set_config
    monkeypatch.chdir(tmp_path)
    jcfg, js, jseq, jhist = jax_anneal
    cfg = set_config(config_from_jax(dataclasses.asdict(jcfg)).replace(
        ed_fused_matvec=route))
    ts, tseq, thist = _sequence(tmain, cfg, tmp_path, device="cpu")
    totals = []
    for k, ((jt, jres), (tt, res)) in enumerate(zip(jseq, tseq)):
        # the budget each solve took is the one the solve before returned
        assert tt == jt == (totals[-1] if totals
                            else ANNEAL["lanc_nstates_total"]), k
        _assert_thermal(res, jres, 16, f"solve {k + 1}")
        totals.append(res.diag.lanc_nstates_total)
    # the budget the last solve but one returned is the one the live
    # config carries; it grew, then settled
    assert ts.cfg.lanc_nstates_total == totals[-2] \
        == js.cfg.lanc_nstates_total
    assert totals[0] > ANNEAL["lanc_nstates_total"] and \
        totals[-1] == totals[-2]
    assert thist == jhist and thist.count("\n\n") == NSOLVES
