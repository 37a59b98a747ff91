"""edipack_tpu_torch's f64 Krylov solvers against edipack_tpu's on the same
operator and the same start vector."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.models.normal import build_normal_sector_op as j_build_op
from edipack_tpu.ops.lanczos import eigsh_lowest as j_eigsh
from edipack_tpu.ops.lanczos import lanczos_tridiag as j_tridiag
from edipack_tpu.ops.matvec import KronMatvec as JKron
from edipack_tpu.sectors import SectorTable as JTable
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.convert import config_from_jax
from edipack_tpu_torch.models.normal import build_normal_sector_op
from edipack_tpu_torch.ops.fused_matvec import FusedKron
from edipack_tpu_torch.ops.fused_normal import build_fused_normal
from edipack_tpu_torch.ops.lanczos import (batched_eigh, eigsh_lowest,
                                           lanczos_sweep, lanczos_tridiag)
from edipack_tpu_torch.ops.matvec import KronMatvec
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
EV_TOL = 1e-10
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)


def _ops(kw, qn):
    jcfg = j_config(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    hloc = np.zeros((1, 1, jcfg.norb, jcfg.norb))
    qn = ("n", (qn[0],), (qn[1],))
    jop = j_build_op(jcfg, JTable(jcfg).by_qn(qn), hloc, j_umatrix(jcfg),
                     j_init_bath(jcfg))
    op = build_normal_sector_op(cfg, SectorTable(cfg).by_qn(qn), hloc,
                                build_umatrix(cfg), init_bath(cfg))
    return jop, op


@pytest.fixture(scope="module")
def sector():
    """norb=2, nbath=3 (4,4) Kanamori sector (dim 4900) and its JAX
    eigenpairs from a numpy start vector."""
    jop, op = _ops(dict(norb=2, nbath=3, nspin=1, **KANAMORI), (4, 4))
    v0 = np.random.default_rng(17).normal(size=op.sector.dim)
    jvals, _ = j_eigsh(JKron(jop, dtype=jnp.float64), op.sector.dim, 3,
                       v0=v0)
    return jop, op, v0, np.asarray(jvals)


def test_eigsh_kron_vs_jax(sector):
    _, op, v0, jvals = sector
    mv = KronMatvec(op, CPU)
    stats = {}
    vals, vecs = eigsh_lowest(mv, mv.dim, 3, v0=v0, stats=stats)
    assert np.abs(vals - jvals).max() <= EV_TOL
    assert stats["n_matvecs"] > 0 and vecs.shape == (3, mv.dim)
    # orthonormal eigenvectors with small residuals
    g = vecs @ vecs.T
    assert torch.allclose(g, torch.eye(3, dtype=g.dtype), atol=1e-10)
    for k in range(3):
        r = mv(vecs[k]) - float(vals[k]) * vecs[k]
        assert float(torch.linalg.norm(r)) < 1e-8


def test_eigsh_fused_vs_jax(sector):
    """Same spectrum through the fused operator (plain version on the CPU),
    whose start vector lives in the padded internal layout."""
    _, op, v0, jvals = sector
    mv = FusedKron(build_fused_normal(op, 2), CPU)
    v0i = mv.to_internal_flat(torch.as_tensor(v0))
    vals, vecs = eigsh_lowest(mv, mv.dim, 3, v0=v0i)
    assert np.abs(vals - jvals).max() <= EV_TOL
    # eigenvectors carry no weight on the padding slots
    assert torch.equal(mv.v0_project(vecs), vecs)


def test_eigsh_default_start(sector):
    _, op, _, jvals = sector
    vals, _ = eigsh_lowest(KronMatvec(op, CPU), op.sector.dim, 2)
    assert np.abs(vals - jvals[:2]).max() <= EV_TOL


def test_eigsh_tiny_dense_shortcut():
    jop, op = _ops(dict(norb=1, nbath=4, nspin=1), (2, 3))
    assert op.sector.dim <= 128
    vals, vecs = eigsh_lowest(KronMatvec(op, CPU), op.sector.dim, 2)
    ref = np.linalg.eigvalsh(jop.to_dense())[:2]
    assert np.abs(vals - ref).max() <= EV_TOL and vecs.shape[0] == 2


def test_lanczos_tridiag_vs_jax(sector):
    jop, op, v0, _ = sector
    m = 12
    ja, jb, jn = j_tridiag(JKron(jop, dtype=jnp.float64), jnp.asarray(v0), m)
    a, b, n0 = lanczos_tridiag(KronMatvec(op, CPU), torch.as_tensor(v0), m)
    assert abs(float(n0) - float(jn)) <= 1e-12 * float(jn)
    assert np.abs(a.numpy() - np.asarray(ja)).max() <= 1e-10
    assert np.abs(b.numpy() - np.asarray(jb)).max() <= 1e-10


def test_lanczos_sweep_orthonormal(sector):
    _, op, v0, _ = sector
    a, b, V = lanczos_sweep(KronMatvec(op, CPU), torch.as_tensor(v0), 30)
    g = V @ V.T
    assert torch.allclose(g, torch.eye(31, dtype=g.dtype), atol=1e-12)


def test_batched_eigh():
    rng = np.random.default_rng(9)
    m = rng.normal(size=(3, 16, 16))
    m = m + m.transpose(0, 2, 1)
    vals, _ = batched_eigh(torch.as_tensor(m))
    assert np.abs(vals.numpy() - np.linalg.eigvalsh(m)).max() <= 1e-12


class _DenseMatvec:
    def __init__(self, h: np.ndarray, dtype: torch.dtype):
        self.h = torch.as_tensor(h, dtype=dtype)
        self.dim = h.shape[0]
        self.device = CPU

    def __call__(self, v):
        return self.h @ v


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_eigsh_restart_cap_keeps_distinct_ritz_pairs(dtype, atol):
    """At the restart cap with several pairs unconverged, eigsh_lowest
    returns the last sweep's Ritz pairs once each: orthonormal vectors,
    distinct values, each value the vector's Rayleigh quotient and above
    the exact eigenvalue of its rank (Cauchy interlacing)."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(300, 300))
    h = (a + a.T) / 2
    mv = _DenseMatvec(h, dtype)
    nev = 3
    stats = {}
    vals, vecs = eigsh_lowest(mv, mv.dim, nev, dtype=dtype, tol=0.0,
                              max_restarts=1, stats=stats)
    assert stats["n_restarts"] == 1 and vecs.shape == (nev, mv.dim)
    g = (vecs @ vecs.T).double()
    assert torch.allclose(g, torch.eye(nev, dtype=g.dtype), atol=atol)
    assert np.all(np.diff(vals) > 1e-3)
    hv = torch.as_tensor(h) @ vecs.double().T
    rq = (vecs.double().T * hv).sum(0).numpy()
    scale = np.abs(vals).max()
    assert np.abs(rq - vals).max() <= atol * scale * 10
    assert np.all(vals >= np.linalg.eigvalsh(h)[:nev] - atol * scale)
