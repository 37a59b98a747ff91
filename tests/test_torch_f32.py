"""The float32 slice end to end: edipack_tpu_torch's ed_solve with
ed_precision="float32" on the CPU, through the fused operator's f32 plain
version (``always``, the CPU side of kernel B2) and f32 KronMatvec
(``never``), against edipack_tpu's f32 ed_solve (route ``never``: f32
KronMatvec, f64 dense buckets) on the same inputs.

Tolerances, from the f32 rounding of both solves: e0 and evals 3e-5; dens,
docc and energies 1e-5; G 1e-4; Σ 1e-3. G and Σ are taken on the Matsubara
grid of β = 20 (BETA_GRID), not the solve's β = 1000: Σ = G0⁻¹ − G⁻¹
amplifies the f32 noise of G by 1/|G|², about 1e4 at β = 1000's lowest
frequency, where edipack_tpu's own f32 Σ differs from its f64 Σ by 4.9e-2
(on the β = 20 grid: 1.8e-4, and G 3.2e-5). Deviations seen on the CPU
against the JAX f32 solve at kanamori_n2b3:
  ``always`` e0 7.6e-6, evals 7.6e-6, dens 1.5e-7, docc 9.6e-8, energies
  1.8e-7, G 2.9e-5, Σ 1.6e-4;
  ``never``  e0 8.6e-6, evals 8.6e-6, dens 2.8e-7, docc 4.7e-8, energies
  8.5e-7, G 2.9e-5, Σ 1.6e-4.
The port's f32 solve lies closer to the f64 solve than the JAX f32 solve
does (``always``: e0 3.5e-6, G 3.3e-6, Σ 1.8e-5 from f64)."""
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
from edipack_tpu_torch.convert import bath_from_array, config_from_jax
from edipack_tpu_torch.device import working_dtype
from edipack_tpu_torch.ops import fused_matvec as fm

torch.set_num_threads(1)
NMATS = 32
BETA_GRID = 20.0     # Matsubara grid of the G and Σ checks (see above)
TOL = dict(e0=3e-5, obs=1e-5, gimp=1e-4, sigma=1e-3)
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
CONFIG = dict(norb=2, nbath=3, nspin=1, ed_precision="float32", **KANAMORI)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden_f32_n2b4.json")


def _summary(mod, res):
    z = 1j * np.pi / BETA_GRID * (2 * np.arange(NMATS) + 1)
    return dict(e0=float(res.e0), dens=np.asarray(mod.ed_get_dens()),
                docc=np.asarray(mod.ed_get_docc()),
                energies=np.asarray(mod.ed_get_eimp()),
                evals=np.asarray(mod.ed_get_evals()),
                neigen=np.asarray(mod.ed_get_neigen_sector()),
                gimp=mod.ed_get_gimp(z), sigma=mod.ed_get_sigma(z))


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    """edipack_tpu's f32 solve of kanamori_n2b3 as on a single-device host,
    in an empty working directory (both packages look for restart files
    there)."""
    import jax
    old = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("torch_f32"))
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        jcfg = j_config(**CONFIG, ed_verbose=0)
        bath = j_bath_to_array(j_init_bath(jcfg))
        jed.ed_init_solver(bath.copy(), cfg=jcfg)
        jed.ed_set_hloc(np.zeros((1, 1, jcfg.norb, jcfg.norb)))
        res = jed.ed_solve()
        ref = _summary(jed, res)
        jed.ed_finalize_solver()
    yield jcfg, bath, ref
    os.chdir(old)


def _deviations(got, ref):
    out = {"e0": abs(got["e0"] - ref["e0"])}
    for k in ("evals", "dens", "docc", "energies", "gimp", "sigma"):
        assert np.shape(got[k]) == np.shape(ref[k]), k
        out[k] = float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
    return out


def _assert_within(dev, what):
    limits = dict(e0=TOL["e0"], evals=TOL["e0"], dens=TOL["obs"],
                  docc=TOL["obs"], energies=TOL["obs"], gimp=TOL["gimp"],
                  sigma=TOL["sigma"])
    for k, lim in limits.items():
        assert dev[k] <= lim, (what, k, dev[k], lim)


@pytest.mark.parametrize("route", ["always", "never"])
def test_f32_slice_vs_jax(jax_f32, route):
    jcfg, bath, ref = jax_f32
    cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
        ed_fused_matvec=route)
    assert working_dtype(cfg) == torch.float32
    before = (fm.launches, fm.launches_f32)
    ted.ed_init_solver(bath.copy(), cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    res = ted.ed_solve()
    got = _summary(ted, res)
    assert np.array_equal(got["neigen"], ref["neigen"])
    _assert_within(_deviations(got, ref), route)
    assert (fm.launches, fm.launches_f32) == before   # CPU: plain versions
    # the Lanczos sectors ran in f32 through the route's operator
    assert res.n_matvecs > 0
    dtypes = {st.vector.dtype for st in res.diag.state_list.states
              if res.table.get_dim(st.sector) > cfg.lanc_dim_threshold}
    assert dtypes <= {torch.float32}
    ted.ed_finalize_solver()


def test_f32_route_selection(jax_f32):
    """f32 auto keeps KronMatvec on the CPU; always takes the fused
    operator (B2's plain version); every Lanczos operator is f32."""
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.solver.core import _normal_builders
    from edipack_tpu_torch.umatrix import build_umatrix
    jcfg, bath, _ = jax_f32
    got = {}
    for route in ("auto", "always", "never"):
        cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
            ed_fused_matvec=route)
        table = SectorTable(cfg)
        b = _normal_builders(cfg, table, np.zeros((1, 1, 2, 2)),
                             build_umatrix(cfg), bath_from_array(bath, cfg),
                             torch.device("cpu"))
        mv = b.matvec_builder(table.by_qn(("n", (4,), (4,))))
        got[route] = (type(mv).__name__, mv.dtype)
    f32 = torch.float32
    assert got == {"auto": ("KronMatvec", f32), "always": ("FusedKron", f32),
                   "never": ("KronMatvec", f32)}


def test_precision_validation():
    assert working_dtype(default_config(norb=1, nbath=2)) == torch.float64
    with pytest.raises(ValueError, match="ed_precision"):
        default_config(norb=1, nbath=2, ed_precision="float16").validate()


@pytest.mark.slow
def test_f32_slice_vs_golden_n2b4(tmp_path, monkeypatch):
    """norb=2, nbath=4 at f32 (twin sectors on) through the fused operator
    on the CPU, against the edipack_tpu numbers that chip_smoke.py holds
    the card to (tests/gen_torch_golden.py): the same configuration's f64
    solve at the tolerances above, and the JAX f32 solve at them too,
    except e0, evals and G. Those the JAX f32 solve itself misses by
    1.11e-4 and 8.0e-5 at this size (its eigenvectors are exact; the Ritz
    values of its f32 recurrence are not), so against it they are held at
    3x that (3.3e-4, 2.4e-4). Seen on the CPU, vs f64: e0 and evals
    1.2e-5, dens 1.4e-6, docc 2.8e-7, energies 3.0e-6, G 7.6e-6, Σ 2.9e-5;
    vs the JAX f32 solve: e0 and evals 1.2e-4, dens 1.3e-6, docc 2.5e-7,
    energies 2.6e-6, G 8.8e-5, Σ 2.8e-4."""
    monkeypatch.chdir(tmp_path)
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    cfg = default_config(**gold["config"], ed_verbose=0,
                         ed_fused_matvec="always")
    ted.ed_init_solver(np.asarray(gold["bath"]), cfg=cfg, device="cpu")
    ted.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    res = ted.ed_solve()
    assert gold["beta_grid"] == BETA_GRID and gold["nmats"] == NMATS
    got = _summary(ted, res)

    def ref(g):
        cplx = lambda a: np.asarray(a)[..., 0] + 1j * np.asarray(a)[..., 1]
        out = {k: np.asarray(g[k]) for k in ("evals", "dens", "docc",
                                             "energies")}
        out.update(e0=g["e0"], gimp=cplx(g["gimp"]), sigma=cplx(g["sigma"]))
        return out

    _assert_within(_deviations(got, ref(gold["f64"])), "vs f64")
    dev = _deviations(got, ref(gold))
    for k, lim in (("e0", 3.3e-4), ("evals", 3.3e-4), ("gimp", 2.4e-4)):
        assert dev.pop(k) <= lim, (k, lim)
    for k, lim in (("dens", TOL["obs"]), ("docc", TOL["obs"]),
                   ("energies", TOL["obs"]), ("sigma", TOL["sigma"])):
        assert dev[k] <= lim, (k, dev[k], lim)
    ted.ed_finalize_solver()


def test_gs_window_keeps_twins_split_by_f32_rounding():
    """At T=0 an f32 solve keeps the levels a few f32 steps above E0 (two
    twin sectors' lowest levels, split by rounding) and drops the next
    level; f64 keeps gs_threshold. The levels are config 2's (norb=2,
    nbath=6) as its f32 solve finds them: the twin 2 f32 steps up, the
    (7,7) level 1.945e-4 up."""
    from edipack_tpu_torch.solver.diag import gs_window
    from edipack_tpu_torch.solver.eigenspace import EigenState, StateList
    e0 = float(np.float32(-15.206272125244))
    step = abs(float(np.spacing(np.float32(e0))))
    sl = StateList([EigenState(e0, 0, None), EigenState(e0 + 2 * step, 1, None),
                    EigenState(e0 + 1.945e-4, 2, None)])
    cfg32 = default_config(**CONFIG)
    cfg64 = cfg32.replace(ed_precision="float64")
    assert gs_window(cfg64, e0) == cfg64.gs_threshold
    kept = {p: [s.sector for s in sl.trim(False, 0.0, gs_window(c, e0), 1)]
            for p, c in (("f32", cfg32), ("f64", cfg64))}
    assert kept == {"f32": [0, 1], "f64": [0]}
