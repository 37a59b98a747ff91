"""nonsu2 solves of edipack_tpu_torch against edipack_tpu on the CPU: e0
1e-10; dens, docc, energies, magnetization, exciton order parameters, G
(every spin block) and Σ 1e-8. A spin-mixing Hloc with in-plane fields
through each joint route (padded ELL, direct COO scatter-add, blocked
Kron), the twin re-solve at finite T, the jz_basis sectors, a general
bath and phonons (mirrors tests/test_nonsu2*.py,
test_nonsu2_dyson_oracle.py, test_twin_nonsu2.py, test_jz_basis.py,
test_general_bath.py and test_joint_phonon.py at small size)."""
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


def _spin_mixing(norb, amp=0.1):
    h = np.zeros((2, 2, norb, norb), complex)
    h[0, 1] = 1j * amp * np.eye(norb)
    h[1, 0] = -1j * amp * np.eye(norb)
    return h


def _t2g_soc(lam):
    """λ L·S on the t2g triplet (tests/test_jz_basis.py's convention)."""
    lz = np.array([[0, -1j, 0], [1j, 0, 0], [0, 0, 0]])
    lp = np.zeros((3, 3), complex)
    lp[0, 1], lp[1, 2] = np.sqrt(2.0), np.sqrt(2.0)
    soc = np.zeros((2, 2, 3, 3), complex)
    soc[0, 0], soc[1, 1] = 0.5 * lz, -0.5 * lz
    soc[0, 1], soc[1, 0] = 0.5 * lp.T, 0.5 * lp
    return lam * soc


def _jz_basis_ops():
    eye = np.zeros((2, 2, 3, 3), complex)
    eye[0, 0] = eye[1, 1] = np.eye(3)
    return np.stack([eye, _t2g_soc(1.0)]), np.array([0.35, 0.1])


def _general_ops():
    h1 = np.zeros((2, 2, 2, 2), complex)
    h1[0, 0] = h1[1, 1] = np.eye(2)
    h2 = _spin_mixing(2, 1.0)
    return np.stack([h1, h2]), np.array([[0.5, 0.1]])


# model, hloc, replica (ops, lambdas) or None, routes
CASES = {
    # the half-filled sector (252 states) through Lanczos
    "spin-mixing": (dict(norb=1, nbath=4, uloc=[2.0], xmu=0.3,
                         spin_field_x=[0.1], spin_field_y=[0.05],
                         lanc_dim_threshold=220),
                    _spin_mixing(1), None, list(ROUTES)),
    "offdiag": (dict(norb=2, nbath=1, uloc=[2.0, 1.5], ust=1.0, jh=0.2,
                     jx=0.2, jp=0.2, spin_field_x=[0.1, 0.0],
                     ed_solve_offdiag_gf=True, lanc_dim_threshold=40),
                _spin_mixing(2) + np.diag([0.1, -0.1])[None, None]
                * np.eye(2)[:, :, None, None], None, list(ROUTES)),
    # finite T keeps states of N != Ns sectors, whose twins are re-solved
    # (dense sectors, every level of each kept: the cutoff then takes
    # whole multiplets, in both packages)
    "twin-finite-t": (dict(norb=1, nbath=2, uloc=[2.0], beta=5.0,
                           ed_finite_temp=True, lanc_nstates_total=64,
                           lanc_nstates_sector=20, cutoff=1e-6,
                           ed_twin=True),
                      np.zeros((2, 2, 1, 1), complex), None, ["ell"]),
    "jz-basis": (dict(norb=3, nbath=1, bath_type="replica", jz_basis=True,
                      uloc=[1.0] * 3, ust=0.4, jh=0.1, jx=0.05, xmu=0.3),
                 _t2g_soc(0.25), _jz_basis_ops(), ["ell"]),
    "general": (dict(norb=2, nbath=1, bath_type="general", uloc=[1.5, 1.2],
                     ust=0.6, jh=0.1, lanc_dim_threshold=40),
                np.zeros((2, 2, 2, 2), complex), _general_ops(),
                ["ell", "kron"]),
    "phonon": (dict(norb=1, nbath=1, uloc=[1.2], xmu=0.6, beta=80.0,
                    spin_field_x=[0.15], nph=2, g_ph=[0.25], w0_ph=0.5,
                    lanc_dim_threshold=8),
               np.zeros((2, 2, 1, 1), complex), None, list(ROUTES)),
}
PARAMS = [(name, r) for name, c in CASES.items() for r in c[3]]


def _inputs(name, make_cfg, make_b, init, umatrix):
    model, hloc, rep, _ = CASES[name]
    cfg = make_cfg(ed_mode="nonsu2", nspin=2, ed_verbose=0, **model)
    basis = None if rep is None else make_b(*rep, nbath=cfg.nbath)
    return cfg, hloc, umatrix(cfg), init(cfg, basis)


def _z(cfg):
    return 1j * np.pi / cfg.beta * (2 * np.arange(16) + 1)


@pytest.fixture(scope="module")
def jax_results():
    """edipack_tpu's result of each case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, hloc, um, bath = _inputs(name, j_config, j_make_basis,
                                          j_init_bath, j_umatrix)
            cache[name] = summary(j_solve(cfg, hloc, um, bath), _z(cfg))
        return cache[name]
    return get


@pytest.mark.parametrize("name,route", PARAMS)
def test_nonsu2_against_jax(jax_results, name, route):
    want = jax_results(name)
    cfg, hloc, um, bath = _inputs(name, default_config, make_basis,
                                  init_bath, build_umatrix)
    res = solve_impurity(cfg.replace(**ROUTES[route]), hloc, um, bath, CPU)
    dev = deviations(summary(res, _z(cfg)), want)
    bad = {k: v for k, v in dev.items() if not v <= TOL[k]}
    assert not bad, (name, route, bad)
    if name in ("spin-mixing", "offdiag"):
        assert res.diag.lanczos_stats, "no sector went through Lanczos"
    if name == "twin-finite-t":
        # the elided N != Ns sectors that the trim keeps were re-solved
        kept = {st.sector for st in res.diag.state_list}
        assert any(not res.table.twin_mask()[i] for i in kept)
