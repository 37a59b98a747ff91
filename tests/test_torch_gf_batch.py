"""Batched GF chains of edipack_tpu_torch on the CPU: ops.lanczos.
lanczos_tridiag_batch against the port's single lanczos_tridiag and
edipack_tpu's lanczos_tridiag_batch (1e-10, one row breaking down at its
first step); every operator that takes a (B, dim) block against B single
calls (1e-12: only the order of sums changes); the chunking of
solver.greens._moments_from_phis (moments as the unchunked batch and the
single chains, 1e-10); and whole solves through the batched chains against
edipack_tpu: normal with phonons, superc (G, F) and nonsu2 on each joint
route (G, Σ 1e-8), and χ (1e-8 of its largest value, as
tests/test_torch_chi.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.ops.lanczos import lanczos_tridiag_batch as j_tridiag_batch
from edipack_tpu.solver.core import solve_impurity as j_solve
from edipack_tpu.umatrix import build_umatrix as j_umatrix

import joint_cases as jc
from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.convert import bath_from_array, config_from_jax
from edipack_tpu_torch.models.joint import build_joint_sector_op
from edipack_tpu_torch.models.joint_kron import build_joint_kron_op
from edipack_tpu_torch.models.normal import build_normal_sector_op
from edipack_tpu_torch.ops.lanczos import (lanczos_tridiag,
                                           lanczos_tridiag_batch)
from edipack_tpu_torch.ops.matvec import (JointMatvec, JointMatvecDirect,
                                          KronMatvec)
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.solver import greens
from edipack_tpu_torch.solver.core import solve_impurity
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
CHAIN_TOL = 1e-10        # short chains (m <= 20), batched against single
OP_TOL = 1e-12           # a row of a batched matvec against its single call
TOL = dict(e0=1e-10, gf=1e-8, chi=1e-8)
M = 16
NB = 5
KANAMORI = dict(uloc=[2.0, 1.6], ust=0.9, jh=0.15, jx=0.1, jp=0.1)
CRYSTAL = np.diag([0.2, -0.2]).reshape(1, 1, 2, 2)
# the solves: several chains (states, orbitals, off-diagonal combinations,
# channels) target one sector; lanc_dim_threshold low enough that those
# sectors run Lanczos chains
PHONON = dict(norb=1, nbath=2, nspin=1, uloc=[2.0], xmu=0.3, nph=3,
              w0_ph=0.6, g_ph=[0.25], beta=5.0, ed_finite_temp=True,
              lanc_nstates_total=4, lanc_nstates_sector=2, cutoff=1e-6,
              lanc_dim_threshold=16)
CHI = dict(norb=2, nbath=1, nspin=1, xmu=0.4, beta=8.0, ed_finite_temp=True,
           lanc_nstates_total=3, lanc_nstates_sector=2,
           lanc_dim_threshold=16, cutoff=1e-6, chispin_flag=True,
           chidens_flag=True, chipair_flag=True, chiexct_flag=True,
           **KANAMORI)
SUPERC = dict(norb=2, nbath=1, nspin=1, ed_mode="superc", uloc=[-2.0, -1.5],
              ust=-1.0, jh=0.25, jx=0.25, jp=0.25, deltasc=0.1,
              lanc_dim_threshold=16)
NONSU2 = dict(norb=2, nbath=1, nspin=2, ed_mode="nonsu2", uloc=[2.0, 2.0],
              ust=1.2, jh=0.25, spin_field_x=[0.1, 0.2],
              lanc_dim_threshold=16)
JOINT = {"superc": (SUPERC, np.diag([0.1, -0.1])[None, None].astype(complex),
                    np.array([[0.05, 0.02], [0.02, -0.03]], complex)),
         "nonsu2": (NONSU2, jc._spin_mixing_hloc(2, 0.1), None)}
ROUTES = {"ell": {}, "direct": dict(ed_sparse_h=False),
          "kron": dict(ed_joint_kron="always")}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def one_device():
    """edipack_tpu as on a single-device host."""
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        yield


# -- lanczos_tridiag_batch ---------------------------------------------------

def _hermitian(dim, complex_, rng):
    """A Hermitian matrix whose first basis vector is an eigenvector: the
    chain from it breaks down at its first step (β exactly 0)."""
    h = rng.normal(size=(dim, dim))
    if complex_:
        h = h + 1j * rng.normal(size=(dim, dim))
    h = h + h.conj().T
    h[0, 1:] = h[1:, 0] = 0.0
    return h


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_tridiag_batch_vs_single_and_jax(complex_):
    rng = np.random.default_rng(3)
    dim = 40
    h = _hermitian(dim, complex_, rng)
    v0 = rng.normal(size=(NB, dim)) + (1j * rng.normal(size=(NB, dim))
                                       if complex_ else 0.0)
    v0[2] = 0.0
    v0[2, 0] = 2.5                       # the chain that breaks down
    ht = torch.as_tensor(h)
    mv = lambda v: v @ ht.T              # one vector or a (B, dim) block
    a, b, n0 = lanczos_tridiag_batch(mv, torch.as_tensor(v0), M)
    assert a.shape == (NB, M) and b.shape == (NB, M - 1) and n0.shape == (NB,)
    assert float(n0[2]) == 2.5 and float(a[2, 0]) == h[0, 0].real
    assert torch.all(a[2, 1:] == 0) and torch.all(b[2] == 0)
    for i in range(NB):
        ai, bi, ni = lanczos_tridiag(mv, torch.as_tensor(v0[i]), M)
        assert _rel(a[i], ai) <= CHAIN_TOL, i
        assert _rel(b[i], bi) <= CHAIN_TOL, i
        assert abs(float(n0[i]) - float(ni)) <= CHAIN_TOL * float(ni)
    hj = jnp.asarray(h)
    ja, jb, jn = j_tridiag_batch(lambda v: hj @ v, jnp.asarray(v0), M)
    assert _rel(a, np.asarray(ja)) <= CHAIN_TOL
    assert _rel(b, np.asarray(jb)) <= CHAIN_TOL
    assert _rel(n0, np.asarray(jn)) <= CHAIN_TOL


# -- operators on a (B, dim) block -------------------------------------------

def _normal_op(model, qn):
    cfg = default_config(**model)
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    hloc[0, 0] = np.diag([0.1, -0.2][:cfg.norb])
    sec = SectorTable(cfg).by_qn(("n", (qn[0],), (qn[1],)))
    return build_normal_sector_op(cfg, sec, hloc, build_umatrix(cfg),
                                  init_bath(cfg))


class _DenseNl:
    """A normal sector op whose non-local factors come only as dense
    matrices (tests/test_torch_matvec.py's fallback case)."""

    def __init__(self, base):
        self.__dict__.update(vars(base))
        self.nl_a, self.nl_b = base.nl_a.copy(), base.nl_b
        self.nl_a[0, 0, :2] += 0.01
        self.nl_perm = None


def _kron_perm():
    op = _normal_op(dict(norb=2, nbath=2, nspin=1, **KANAMORI), (3, 2))
    mv = KronMatvec(op, CPU)
    assert mv.nl.perm is not None
    return mv


def _kron_dense():
    op = _normal_op(dict(norb=2, nbath=2, nspin=1, **KANAMORI), (3, 2))
    mv = KronMatvec(_DenseNl(op), CPU)
    assert mv.nl_dense is not None
    return mv


def _kron_phonon():
    mv = KronMatvec(_normal_op(dict(norb=1, nbath=2, nspin=1, uloc=[1.0],
                                    nph=3, w0_ph=0.7, g_ph=[0.4], a_ph=0.1),
                               (2, 1)), CPU)
    assert mv.has_ph
    return mv


def _joint(kind, model, qn):
    cfg = default_config(**model)
    sec = SectorTable(cfg).by_qn(qn)
    ns = cfg.nspin
    args = (cfg, sec, np.zeros((ns, ns, cfg.norb, cfg.norb), complex),
            build_umatrix(cfg), init_bath(cfg))
    if kind == "kron":
        mv = build_joint_kron_op(*args, CPU)
    else:
        cls = JointMatvec if kind == "ell" else JointMatvecDirect
        mv = cls(build_joint_sector_op(*args), CPU)
    assert mv.has_ph == (cfg.nph > 0)
    return mv


JOINT_PHONON = dict(norb=1, nbath=2, nspin=1, ed_mode="superc", uloc=[-1.5],
                    deltasc=0.12, nph=3, g_ph=[0.3], w0_ph=0.7)
OPERATORS = {
    "normal-perm": _kron_perm, "normal-dense": _kron_dense,
    "normal-phonon": _kron_phonon,
    **{f"joint-{kind}-{name}": (lambda kind=kind, model=model, qn=qn:
                                _joint(kind, model, qn))
       for kind in ("ell", "direct", "kron")
       for name, model, qn in (("nonsu2", NONSU2, ("nt", 4)),
                               ("phonon", JOINT_PHONON, ("sz", 0)))},
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_block_vs_single_calls(name):
    mv = OPERATORS[name]()
    assert mv.batched
    rng = np.random.default_rng(4)
    dt = mv.dtype
    v = torch.as_tensor(rng.normal(size=(NB, mv.dim)), dtype=dt)
    if dt.is_complex:
        v = v + 1j * torch.as_tensor(rng.normal(size=(NB, mv.dim)))
    calls = mv.n_calls
    out = mv(v)
    assert mv.n_calls == calls + 1 and out.shape == (NB, mv.dim)
    for i in range(NB):
        assert _rel(out[i], mv(v[i])) <= OP_TOL, i


# -- the chunks of _moments_from_phis ----------------------------------------

def test_moments_chunked_as_batch_and_single(monkeypatch):
    """Five chains into one sector: one batch, chunks of two (the last
    chunk a single chain), and one chain at a time give the same moments."""
    mv = _kron_perm()
    rng = np.random.default_rng(5)
    phis = [torch.as_tensor(rng.normal(size=mv.dim)) for _ in range(NB)]
    calls = []
    batch = greens.lanczos_tridiag_batch
    monkeypatch.setattr(greens, "lanczos_tridiag_batch",
                        lambda f, v0s, m: calls.append(len(v0s))
                        or batch(f, v0s, m))
    whole = greens._moments_from_phis(mv, phis, M)
    assert calls == [NB]
    dim = mv.dim
    monkeypatch.setattr(greens, "GF_BATCH_BYTES", 2 * 4 * dim * 16)
    chunked = greens._moments_from_phis(mv, phis, M)
    assert calls == [NB, 2, 2]
    monkeypatch.setattr(greens, "BATCH_CHAINS", False)
    single = greens._moments_from_phis(mv, phis, M)
    assert calls == [NB, 2, 2]
    for (w, e), (wc, ec), (ws, es) in zip(whole, chunked, single):
        assert _rel(wc, w) <= CHAIN_TOL and _rel(ec, e) <= CHAIN_TOL
        assert _rel(ws, w) <= CHAIN_TOL and _rel(es, e) <= CHAIN_TOL


def test_fused_operator_runs_one_chain_at_a_time(monkeypatch):
    """B1/B2's fused operator takes one vector: no batch."""
    from edipack_tpu_torch.ops.fused_matvec import FusedKron
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    op = _normal_op(dict(norb=2, nbath=2, nspin=1, **KANAMORI), (3, 2))
    mv = FusedKron(build_fused_normal(op, 2), CPU)
    assert not getattr(mv, "batched", False)
    monkeypatch.setattr(greens, "lanczos_tridiag_batch", None)
    rng = np.random.default_rng(6)
    phis = [torch.as_tensor(rng.normal(size=op.sector.dim))
            for _ in range(3)]
    assert len(greens._moments_from_phis(mv, phis, M)) == 3


# -- whole solves against edipack_tpu ----------------------------------------

@pytest.fixture
def batch_widths(monkeypatch):
    """The widths of the batched GF launches of the test."""
    widths = []
    batch = greens.lanczos_tridiag_batch
    monkeypatch.setattr(greens, "lanczos_tridiag_batch",
                        lambda f, v0s, m: widths.append(len(v0s))
                        or batch(f, v0s, m))
    return widths


def _port_cfg(jcfg, **route):
    return config_from_jax(dataclasses.asdict(jcfg)).replace(
        ed_fused_matvec="never", **route)


def _solve_both(model, hloc, han=None, routes=({},)):
    jcfg = j_config(**model, ed_verbose=0)
    jbath = j_init_bath(jcfg)
    kw = {} if han is None else dict(hloc_anomalous=han)
    jres = j_solve(jcfg, hloc, j_umatrix(jcfg), jbath, **kw)
    ports = []
    for route in routes:
        cfg = _port_cfg(jcfg, **route)
        ports.append(solve_impurity(
            cfg, hloc, build_umatrix(cfg),
            bath_from_array(j_bath_to_array(jbath), cfg), CPU, **kw))
    return jres, ports


def _assert_gf(jres, res, what):
    z = jc._z(jres.cfg.beta)
    want, got = jc.summary(jres, z), jc.summary(res, z)
    assert abs(got["e0"] - want["e0"]) <= TOL["e0"], what
    for k in ("gimp", "sigma", "impf", "self", "dimp"):
        if k in want:
            dev = float(np.abs(got[k] - want[k]).max())
            assert dev <= TOL["gf"], (what, k, dev)


def test_normal_phonon_solve_vs_jax(one_device, batch_widths):
    jres, (res,) = _solve_both(PHONON, np.zeros((1, 1, 1, 1)))
    assert max(batch_widths) > 1
    _assert_gf(jres, res, "normal, phonons")


@pytest.fixture(scope="module", params=sorted(JOINT))
def joint_jax(request, one_device):
    model, hloc, han = JOINT[request.param]
    jcfg = j_config(**model, ed_verbose=0)
    jbath = j_init_bath(jcfg)
    jres = j_solve(jcfg, hloc, j_umatrix(jcfg), jbath, hloc_anomalous=han)
    return jres, jbath, hloc, han


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_joint_solve_vs_jax(joint_jax, route, batch_widths):
    jres, jbath, hloc, han = joint_jax
    cfg = _port_cfg(jres.cfg, **ROUTES[route])
    res = solve_impurity(cfg, hloc, build_umatrix(cfg),
                         bath_from_array(j_bath_to_array(jbath), cfg), CPU,
                         hloc_anomalous=han)
    assert max(batch_widths) > 1
    _assert_gf(jres, res, f"{cfg.ed_mode} via {route}")


def test_chi_solve_vs_jax(one_device, batch_widths):
    jres, (res,) = _solve_both(CHI, CRYSTAL)
    assert max(batch_widths) > 1
    _assert_gf(jres, res, "chi model")
    z = 1j * 2 * np.pi / jres.cfg.beta * np.arange(1, 33)
    for kind in ("spin", "dens", "pair", "exct_s", "exct_tz", "exct_t"):
        want = jres.get_chi(kind, z)
        scale = np.abs(want).max()
        assert scale > 0, kind
        assert np.abs(res.get_chi(kind, z) - want).max() / scale \
            <= TOL["chi"], kind
