"""Write the edipack_tpu reference numbers that edipack_tpu_torch is held to
on the card (chip_smoke.py) and in the slow CPU tests
(tests/test_torch_solve.py, tests/test_torch_f32.py, tests/test_torch_dmft.py).

    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py [float64] [float32] [dmft]

Runs the JAX package's ed_solve on the CPU at norb=2, nbath=4 with the
two-orbital Kanamori parameters of bench.py and writes, for each precision
named (both by default):

* float64: tests/data/torch_port_golden_n2b4.json (f64 KronMatvec, exact GF
  moments);
* float32: tests/data/torch_port_golden_f32_n2b4.json (``ed_precision=
  "float32"``: f32 KronMatvec, the route ``never`` the CPU takes; f64 dense
  buckets), with ``ed_twin=True``. The ground level is a doublet of twin
  sectors, (4,6) and (6,4), 2.6e-14 apart at f64; without twins an f32
  solve keeps only the member that rounding puts lower, and the spin-up G
  of the two differs by 1.1e-2. Twins give both the same energy, so every
  solve keeps both. G and Σ are taken on the Matsubara grid of
  ``beta_grid``, whose lowest frequency the f32 solve resolves (see
  tests/test_torch_f32.py). Under the key ``f64`` the file also holds the
  same configuration solved in f64 (twins on, G and Σ on the same grid):
  the JAX f32 solve lies 1.1e-4 from that e0 at this size, so the f32
  checks hold the port to both.

* dmft: tests/data/torch_port_golden_dmft_n2b4.json, two iterations of
  the Bethe-lattice DMFT loop at the same configuration with
  ``cg_scheme="delta"`` and ``cg_method=1`` (about 4 min): solve, Δ =
  (D/2)² G with D = 1, the χ² fit of the bath to Δ, and again from the
  fitted bath in the same solver. For each loop: e0, dens, docc, G and Σ,
  and the packed bath the fit returned. No mixing: each loop's Δ is (D/2)²
  times its own G. The fit is L-BFGS-B (``cg_method=1``), which stops on
  its own criterion: the default CG stops at cg_niter here, and the point
  where it stops moves with the last bits of its target
  (tests/test_torch_fit.py), so no golden number could hold it.

Not collected by pytest (the file name does not start with ``test_``).
"""
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import edipack_tpu.main as ed  # noqa: E402
from edipack_tpu.config import default_config  # noqa: E402

OUT = os.path.join(HERE, "data", "torch_port_golden_n2b4.json")
OUT_F32 = os.path.join(HERE, "data", "torch_port_golden_f32_n2b4.json")
OUT_DMFT = os.path.join(HERE, "data", "torch_port_golden_dmft_n2b4.json")
# the DMFT golden: Bethe lattice of half-bandwidth D, two loops
DMFT = dict(cg_scheme="delta", cg_method=1)
WBAND = 1.0
DMFT_LOOPS = 2
CONFIG = dict(norb=2, nbath=4, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
              jx=0.15, jp=0.15)
NMATS = 32
BETA_GRID_F32 = 20.0


def pairs(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], axis=-1).tolist()


def solve(config, beta_grid=None):
    """One ed_solve of ``config``; its results, G and Σ on the Matsubara
    grid of ``beta_grid`` (default: the solve's β)."""
    cfg = default_config(**config, ed_verbose=0)
    assert dataclasses.asdict(cfg)["lanc_dim_threshold"] == 1024
    bath = ed.ed_init_solver(cfg=cfg)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    res = ed.ed_solve(bath)
    z = 1j * np.pi / (beta_grid or cfg.beta) * (2 * np.arange(NMATS) + 1)
    out = dict(
        e0=float(res.e0), evals=np.asarray(res.evals).tolist(),
        dens=np.asarray(res.dens).tolist(),
        docc=np.asarray(res.docc).tolist(),
        energies=np.asarray(res.energies).tolist(),
        gimp=pairs(ed.ed_get_gimp(z)), sigma=pairs(ed.ed_get_sigma(z)))
    ed.ed_finalize_solver()
    return cfg, np.asarray(bath).tolist(), out


def write_golden(precision):
    if precision == "float64":
        cfg, bath, res = solve(CONFIG)
        out = dict(source="edipack_tpu ed_solve on the CPU (f64 KronMatvec, "
                          "exact GF)", config=CONFIG, beta=cfg.beta)
    else:
        config = dict(CONFIG, ed_precision=precision, ed_twin=True)
        cfg, bath, res = solve(config, BETA_GRID_F32)
        _, bath64, res64 = solve(dict(config, ed_precision="float64"),
                                 BETA_GRID_F32)
        assert bath64 == bath
        out = dict(source="edipack_tpu ed_solve on the CPU, "
                          "ed_precision=float32 (f32 KronMatvec, route "
                          "never; f64 dense buckets); under f64 the same "
                          "configuration in f64", config=config,
                   beta=cfg.beta, beta_grid=BETA_GRID_F32)
    out.update(nmats=NMATS, bath=bath, **res)
    if precision != "float64":
        out["f64"] = res64
    path = OUT if precision == "float64" else OUT_F32
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {path}: e0 {res['e0']}")


def dmft_loops(mod, cfg, nloops=DMFT_LOOPS, **init):
    """``nloops`` Bethe-lattice DMFT iterations of ``cfg`` through the
    ``ed_*`` API of ``mod`` (edipack_tpu.main or edipack_tpu_torch.main,
    whose config module must hold ``cfg`` as the current one): solve, then
    fit the bath to Δ = (D/2)² G. ``init``: extra ed_init_solver arguments.
    Returns one record per loop."""
    z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
    bath = mod.ed_init_solver(cfg=cfg, **init)
    mod.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    out = []
    for _ in range(nloops):
        res = mod.ed_solve(bath)
        delta = (WBAND / 2.0) ** 2 * mod.ed_get_gimp(axis="m")
        bath = mod.ed_chi2_fitgf(delta, bath, ispin=1)
        out.append(dict(e0=float(res.e0), dens=np.asarray(res.dens),
                        docc=np.asarray(res.docc), gimp=mod.ed_get_gimp(z),
                        sigma=mod.ed_get_sigma(z), bath=np.asarray(bath)))
    mod.ed_finalize_solver()
    return out


def write_dmft_golden():
    import subprocess
    from edipack_tpu.config import set_config
    config = dict(CONFIG, **DMFT)
    cfg = set_config(default_config(**config, ed_verbose=0))
    loops = dmft_loops(ed, cfg)
    commit = subprocess.run(["git", "log", "-1", "--format=%h", "--",
                             "edipack_tpu"], capture_output=True, text=True,
                            cwd=os.path.dirname(HERE)).stdout.strip()
    out = dict(source=f"edipack_tpu (last commit {commit}) on the CPU: "
                      f"{DMFT_LOOPS} Bethe DMFT loops through ed_solve (f64 "
                      f"KronMatvec, exact GF) and ed_chi2_fitgf, D = "
                      f"{WBAND}, no mixing", config=config, beta=cfg.beta,
               nmats=NMATS, wband=WBAND, lfit=cfg.lfit,
               loops=[{k: pairs(v) if k in ("gimp", "sigma") else
                       (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in rec.items()} for rec in loops])
    with open(OUT_DMFT, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {OUT_DMFT}: e0 {[r['e0'] for r in loops]}")


def main(modes):
    for mode in modes or ("float64", "float32"):
        if mode == "dmft":
            write_dmft_golden()
        else:
            write_golden(mode)


if __name__ == "__main__":
    main(sys.argv[1:])
