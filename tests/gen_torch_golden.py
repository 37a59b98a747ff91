"""Write the edipack_tpu reference numbers that edipack_tpu_torch is held to
on the card (chip_smoke.py) and in the slow CPU test
(tests/test_torch_solve.py).

    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py

Runs the JAX package's ed_solve on the CPU at norb=2, nbath=4 with the
two-orbital Kanamori parameters of bench.py (f64 KronMatvec, exact GF
moments) and writes tests/data/torch_port_golden_n2b4.json. Not collected
by pytest (the file name does not start with ``test_``).
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
CONFIG = dict(norb=2, nbath=4, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
              jx=0.15, jp=0.15)
NMATS = 32


def pairs(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], axis=-1).tolist()


def main():
    cfg = default_config(**CONFIG, ed_verbose=0)
    bath = ed.ed_init_solver(cfg=cfg)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    res = ed.ed_solve(bath)
    z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
    out = dict(
        source="edipack_tpu ed_solve on the CPU (f64 KronMatvec, exact GF)",
        config=CONFIG, beta=cfg.beta, nmats=NMATS,
        bath=np.asarray(bath).tolist(),
        e0=float(res.e0), evals=np.asarray(res.evals).tolist(),
        dens=np.asarray(res.dens).tolist(),
        docc=np.asarray(res.docc).tolist(),
        energies=np.asarray(res.energies).tolist(),
        gimp=pairs(ed.ed_get_gimp(z)), sigma=pairs(ed.ed_get_sigma(z)))
    assert dataclasses.asdict(cfg)["lanc_dim_threshold"] == 1024
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {OUT}: e0 {res.e0}")


if __name__ == "__main__":
    main()
