"""Impurity RDM (solver/rdm.py), configuration probabilities, the phonon
position PDF and the Krylov complexities (solver/krylov.py) of
edipack_tpu_torch against edipack_tpu on the CPU, through the fused
operator's plain version (route ``always``) and KronMatvec (``never``).
Mirrors tests/test_phonon_chi_rdm.py::test_rdm_vs_oracle_trace,
::test_configuration_probabilities_and_phonon_pdf and tests/test_krylov.py.

RDM, probabilities, PDF, complexity, entropy and the Krylov distribution
at 1e-8. The Krylov models are one-orbital: a chain of 200 steps without
reorthogonalization (the reference's and edipack_tpu's) loses
orthogonality, and from there it amplifies rounding, so two correct
implementations drift apart late in the chain. At norb=2, nbath=2 the two
packages' operator complexities differ by up to 1.1e-6 and their state
complexities by up to 2.6e-9 (measured on a CPU); at norb=1, nbath=3
both stay within 1e-12.
"""
import dataclasses

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

from oracle import FockOracle, oracle_normal_hamiltonian

torch.set_num_threads(1)
TOL = 1e-8
CPU = torch.device("cpu")
ROUTES = ("always", "never")
# two-orbital Kanamori at finite T (three kept states, two weights)
RDM_MODEL = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 1.6], ust=0.9,
                 jh=0.15, jx=0.1, jp=0.1, xmu=0.4, beta=8.0,
                 ed_finite_temp=True, lanc_nstates_total=3,
                 lanc_nstates_sector=2, lanc_dim_threshold=350, cutoff=1e-6,
                 rdm_flag=True)
ORACLE_MODEL = dict(norb=1, nbath=2, nspin=1, uloc=[1.7], xmu=0.21,
                    rdm_flag=True)
PDF_MODEL = dict(norb=2, nbath=1, nspin=1, uloc=[2.0, 2.0], ust=0.8,
                 xmu=0.5, nph=10, w0_ph=1.0, g_ph=[0.3, 0.2], lpos=200,
                 xmin=-5, xmax=5)
KRYLOV_MODEL = dict(norb=1, nbath=3, nspin=1, uloc=[2.0], xmu=0.1,
                    tmax=5.0, ltimes=40, lanc_dim_threshold=16)


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


def _both(model, hloc, routes=ROUTES, flag_gf=True):
    jcfg = j_config(**model, ed_verbose=0)
    jbath = j_init_bath(jcfg)
    jres = j_solve(jcfg, hloc, j_umatrix(jcfg), jbath, flag_gf=flag_gf)
    ports = {}
    for route in routes:
        cfg = config_from_jax(dataclasses.asdict(jcfg)).replace(
            ed_fused_matvec=route)
        ports[route] = solve_impurity(
            cfg, hloc, build_umatrix(cfg),
            bath_from_array(j_bath_to_array(jbath), cfg), CPU,
            flag_gf=flag_gf)
    return jres, ports


@pytest.fixture(scope="module")
def rdm_pair(one_device):
    return _both(RDM_MODEL, np.diag([0.2, -0.2]).reshape(1, 1, 2, 2),
                 flag_gf=False)


@pytest.mark.parametrize("route", ROUTES)
def test_rdm_and_reduced_vs_jax(rdm_pair, route):
    from edipack_tpu.solver.rdm import get_reduced_rdm as j_reduced
    from edipack_tpu_torch.solver.rdm import get_reduced_rdm
    jres, ports = rdm_pair
    res = ports[route]
    assert len(res.diag.state_list) == 3 and "impurity_rdm" in res.timings
    rho = res.get_rdm()
    assert rho.shape == (16, 16)
    assert np.abs(rho - jres.get_rdm()).max() <= TOL
    assert abs(np.trace(rho) - 1.0) < 1e-10
    assert np.abs(rho - rho.T).max() < 1e-12
    for mask in ([True, False], [False, True], [True, True]):
        got = get_reduced_rdm(rho, mask, 2)
        assert np.abs(got - j_reduced(jres.get_rdm(), mask, 2)).max() <= TOL
    # the diagonal gives the densities: I = iu + 4 id
    idx = np.arange(16)
    for a in range(2):
        n_a = np.diag(rho) @ (((idx % 4) >> a & 1) + ((idx // 4) >> a & 1))
        assert abs(n_a - res.dens[a]) <= TOL


def test_rdm_vs_oracle_trace(one_device):
    """The port's RDM against the oracle's partial trace over the bath of
    the ground multiplet (tests/test_phonon_chi_rdm.py)."""
    hloc = np.zeros((1, 1, 1, 1))
    jres, ports = _both(ORACLE_MODEL, hloc, routes=("always",))
    res = ports["always"]
    rho = res.get_rdm()
    orc = FockOracle(3, convention="per-spin")
    h = oracle_normal_hamiltonian(orc, jres.cfg, hloc, jres.um, jres.bath)
    evals, evecs = np.linalg.eigh(h.toarray())
    deg = np.nonzero(evals - evals[0] <= 1e-9)[0]
    rho_or = np.zeros((4, 4))
    for g in deg:
        psi = evecs[:, g]
        for m in range(orc.dim):
            iu, bu = m & 1, (m >> 1) & 3
            idn, bd = (m >> 3) & 1, (m >> 4) & 3
            for mp in range(orc.dim):
                ju, bu2 = mp & 1, (mp >> 1) & 3
                jd, bd2 = (mp >> 3) & 1, (mp >> 4) & 3
                if bu == bu2 and bd == bd2:
                    rho_or[iu + 2 * idn, ju + 2 * jd] += \
                        psi[m] * psi[mp] / len(deg)
    assert np.abs(rho - rho_or).max() < 1e-9
    assert np.abs(rho - jres.get_rdm()).max() <= TOL
    assert np.all(np.linalg.eigvalsh(rho) > -1e-12)


def test_probabilities_and_phonon_pdf_vs_jax(one_device):
    from edipack_tpu.solver.observables import phonon_position_pdf as j_pdf
    from edipack_tpu_torch.solver.observables import phonon_position_pdf
    jres, ports = _both(PDF_MODEL, np.zeros((1, 1, 2, 2)),
                        routes=("never",))
    res = ports["never"]
    assert np.abs(res.obs.prob - jres.obs.prob).max() <= TOL
    assert abs(res.obs.prob.sum() - 1.0) < 1e-9
    x, pdf = phonon_position_pdf(res.cfg, res.obs)
    jx, jpdf = j_pdf(jres.cfg, jres.obs)
    assert np.array_equal(x, jx) and pdf.shape == (200,)
    assert np.abs(pdf - jpdf).max() <= TOL
    dx = x[1] - x[0]
    assert abs(pdf.sum() * dx - 1.0) < 1e-3


@pytest.fixture(scope="module")
def krylov_pair(one_device):
    return _both(KRYLOV_MODEL, np.zeros((1, 1, 1, 1)), flag_gf=False)


def _assert_krylov(got, want, what):
    assert np.array_equal(got.times, want.times)
    assert set(got.complexity) == set(want.complexity), what
    for key in want.complexity:
        for field in ("complexity", "entropy", "distribution"):
            a, b = getattr(got, field)[key], getattr(want, field)[key]
            assert a.shape == b.shape, (what, key, field)
            assert np.abs(a - b).max() <= TOL, (what, key, field)


@pytest.mark.parametrize("route", ROUTES)
def test_krylov_state_complexity_vs_jax(krylov_pair, route):
    """c†, c and the g1 = c† + c chain on the direct sum of the two target
    sectors; with route always each part of the g1 seed goes to its own
    fused operator's layout."""
    from edipack_tpu.solver.krylov import krylov_state_complexity as j_ksc
    from edipack_tpu_torch.solver.krylov import (krylov_state_complexity,
                                                 result_matvec)
    jres, ports = krylov_pair
    res = ports[route]
    kr = krylov_state_complexity(res)
    _assert_krylov(kr, j_ksc(jres), route)
    for key, k in kr.complexity.items():
        assert abs(k[0]) < 1e-10 and k[1] > 0
        assert np.abs(kr.distribution[key].sum(0) - 1.0).max() < 1e-10
    gs = min(res.diag.state_list, key=lambda s: s.energy)
    sec = res.table.sector(res.table.cdg_sector(gs.sector, 0))
    want = "FusedKron" if route == "always" else "KronMatvec"
    assert type(result_matvec(res, sec)).__name__ == want


@pytest.mark.parametrize("route", ROUTES)
def test_krylov_operator_complexity_vs_jax(krylov_pair, route):
    from edipack_tpu.solver.krylov import \
        krylov_operator_complexity as j_koc
    from edipack_tpu_torch.solver.krylov import krylov_operator_complexity
    jres, ports = krylov_pair
    res = ports[route]
    ops = ["cdg", "c", "g1"]
    _assert_krylov(krylov_operator_complexity(res, ops=ops),
                   j_koc(jres, ops=ops), route)
    # the dense-block guard
    with pytest.raises(NotImplementedError, match="dense-block limit"):
        krylov_operator_complexity(res, ops=ops, dense_dim_max=8)


def test_krylov_g1_combined_chain_dense_oracle(krylov_pair):
    """g1 through the fused layout against an explicit Gram-Schmidt Krylov
    basis of the dense direct-sum H and its exact evolution
    (tests/test_krylov.py)."""
    from edipack_tpu_torch.ops.sector_ops import spin_axis_op
    from edipack_tpu_torch.solver.krylov import (krylov_state_complexity,
                                                 result_matvec)
    _, ports = krylov_pair
    res = ports["always"]
    kr = krylov_state_complexity(res, ops=["g1"])
    table = res.table
    st = min(res.diag.state_list, key=lambda s: s.energy)
    sec = table.sector(st.sector)
    v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
    t1 = table.sector(table.cdg_sector(st.sector, 0, 0))
    t2 = table.sector(table.c_sector(st.sector, 0, 0))
    phi = np.concatenate([
        spin_axis_op(sec.ups, t.ups, sec.ns, k, 0, 2).apply(v3)
        .reshape(-1).numpy() for t, k in ((t1, "cdg"), (t2, "c"))])
    blocks = []
    for t in (t1, t2):
        mv = result_matvec(res, t)
        eye = torch.eye(t.dim, dtype=torch.float64)
        blocks.append(torch.stack([
            mv.from_internal_flat(mv(mv.to_internal_flat(eye[i])))
            for i in range(t.dim)], dim=1).numpy())
    h = np.zeros((t1.dim + t2.dim,) * 2)
    h[:t1.dim, :t1.dim], h[t1.dim:, t1.dim:] = blocks
    phi = phi / np.linalg.norm(phi)
    basis = [phi]
    w = h @ phi
    while True:
        for _ in range(2):
            for q in basis:
                w = w - (q @ w) * q
        nw = np.linalg.norm(w)
        if nw < 1e-10 or len(basis) >= h.shape[0]:
            break
        basis.append(w / nw)
        w = h @ basis[-1]
    q = np.stack(basis)
    ev, u = np.linalg.eigh(h)
    k_oracle = np.array([
        (np.arange(len(basis)) * np.abs(
            q @ ((u * np.exp(-1j * ev * t)) @ (u.T @ phi))) ** 2).sum()
        for t in kr.times])
    np.testing.assert_allclose(kr.complexity[("g1", 0, 0)], k_oracle,
                               atol=1e-6)
