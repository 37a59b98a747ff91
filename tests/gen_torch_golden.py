"""Write the edipack_tpu reference numbers that edipack_tpu_torch is held to
on the card (chip_smoke.py) and in the slow CPU tests
(tests/test_torch_solve.py, tests/test_torch_f32.py).

    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py [float64] [float32]

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


def main(precisions):
    for precision in precisions or ("float64", "float32"):
        write_golden(precision)


if __name__ == "__main__":
    main(sys.argv[1:])
