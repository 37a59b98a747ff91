"""superc solves of edipack_tpu_torch against edipack_tpu on the CPU, through
each joint route (padded ELL, direct COO scatter-add, blocked Kron): e0
1e-10; dens, docc, energies, φ, G, F, Σ and the anomalous self-energy
1e-8. Normal, hybrid and replica (Nambu) baths, an anomalous Hloc, spin
twins and phonons (mirrors tests/test_superc*.py,
test_superc_dyson_oracle.py, test_twin_superc.py and test_joint_phonon.py
at small size)."""
import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.bath.replica import make_basis as j_make_basis
from edipack_tpu.config import default_config as j_config
from edipack_tpu.solver.core import solve_impurity as j_solve
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.bath.replica import make_basis
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.solver.core import solve_impurity
from edipack_tpu_torch.umatrix import build_umatrix

from joint_cases import TOL, deviations, summary

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROUTES = {"ell": {}, "direct": dict(ed_sparse_h=False),
          "kron": dict(ed_joint_kron="always")}
NAMBU = np.zeros((2, 2, 2, 2, 2), complex)
NAMBU[0, 0, 0] = np.diag([1.0, -1.0])
NAMBU[0, 1, 1] = -NAMBU[0, 0, 0].T
NAMBU[1, 0, 1] = NAMBU[1, 1, 0] = np.eye(2)
# model, hloc, anomalous Hloc, replica (ops, lambdas)
CASES = {
    # sectors of 252 states through Lanczos (lanc_dim_threshold 100), the
    # Sz < 0 twins rebuilt by the signed spin swap
    "normal-twin": (dict(norb=1, nbath=4, uloc=[-2.0], deltasc=0.1,
                         xmu=0.1, ed_twin=True, lanc_dim_threshold=100),
                    np.full((1, 1, 1, 1), 0.05), None, None),
    "hybrid": (dict(norb=2, nbath=2, bath_type="hybrid", uloc=[-1.5, -1.0],
                    ust=-0.5, jh=0.2, jx=0.2, jp=0.2, deltasc=0.05,
                    lanc_dim_threshold=32),
               np.diag([0.1, -0.1])[None, None],
               np.array([[0.02, 0.01], [0.01, 0.02]]), None),
    "replica": (dict(norb=2, nbath=1, bath_type="replica",
                     uloc=[-1.0, -1.0], lanc_dim_threshold=32),
                np.zeros((1, 1, 2, 2)), None,
                (NAMBU, np.array([[0.4, 0.2]]))),
    "phonon": (dict(norb=1, nbath=2, uloc=[-1.5], deltasc=0.12, xmu=0.1,
                    beta=80.0, nph=3, g_ph=[0.3], w0_ph=0.7,
                    lanc_dim_threshold=64),
               np.zeros((1, 1, 1, 1)), None, None),
}


def _inputs(name, make_cfg, make_b, init, umatrix):
    model, hloc, han, rep = CASES[name]
    cfg = make_cfg(ed_mode="superc", nspin=1, ed_verbose=0, **model)
    basis = None if rep is None else make_b(*rep, nbath=cfg.nbath)
    return cfg, hloc, han, umatrix(cfg), init(cfg, basis)


@pytest.fixture(scope="module", params=list(CASES))
def jax_result(request):
    name = request.param
    cfg, hloc, han, um, bath = _inputs(name, j_config, j_make_basis,
                                       j_init_bath, j_umatrix)
    res = j_solve(cfg, hloc, um, bath, hloc_anomalous=han)
    return name, summary(res, 1j * np.pi / cfg.beta * (2 * np.arange(16)
                                                       + 1))


@pytest.mark.parametrize("route", list(ROUTES))
def test_superc_against_jax(jax_result, route):
    name, want = jax_result
    cfg, hloc, han, um, bath = _inputs(name, default_config, make_basis,
                                       init_bath, build_umatrix)
    res = solve_impurity(cfg.replace(**ROUTES[route]), hloc, um, bath, CPU,
                         hloc_anomalous=han)
    got = summary(res, 1j * np.pi / cfg.beta * (2 * np.arange(16) + 1))
    dev = deviations(got, want)
    bad = {k: v for k, v in dev.items() if not v <= TOL[k]}
    assert not bad, (name, route, bad)
    if name in ("normal-twin", "phonon"):
        assert res.diag.lanczos_stats, "no sector went through Lanczos"
