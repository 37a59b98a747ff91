"""edipack_tpu_torch's f32 kernels' plain PyTorch versions (the CPU side of
kernels B2, B3 and B4) against edipack_tpu's on the same inputs:

* B2, the f32 fused sector matvec, against the TPU package's NumPy oracle
  on its f32 tables (``apply_ref``) and its f32 KronMatvec, at relative
  3e-6 (tests/test_fused.py's bound for 'highest');
* B3, the chained power steps, against the oracle's power loop, norms and
  the final normalized vector at 1e-5 (tests/test_fused.py);
* B4, the Kron operator (a sparse row-gather kernel on ELL tables of the
  hop factors, unpadded), against the TPU package's KronPallasMatvec
  (interpret mode) and f32 KronMatvec, and its ELL plain version against
  the dense formula, at atol 1e-4 (tests/test_pallas_kron.py).

The CUDA kernels themselves are held to these plain versions on the card
(the tests marked ``cuda``, and chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.models.normal import build_normal_sector_op as j_build_op
from edipack_tpu.ops.fused_normal import build_fused_normal as j_build_fused
from edipack_tpu.ops.matvec import KronMatvec as JKron
from edipack_tpu.sectors import SectorTable as JTable
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.convert import config_from_jax
from edipack_tpu_torch.models.normal import build_normal_sector_op
from edipack_tpu_torch.ops import fused_matvec as fm
from edipack_tpu_torch.ops import kron_tiles as kt
from edipack_tpu_torch.ops.fused_normal import build_fused_normal
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL_B2 = 3e-6
TOL_B3 = 1e-5
ATOL_B4 = 1e-4
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
# nbath=4 (5,4): 2x2 tiles, runs with source-block offsets and lane shifts
FUSED = (dict(norb=2, nbath=4, nspin=1, **KANAMORI), (5, 4),
         np.diag([0.1, -0.2]))
# tests/test_pallas_kron.py's sector
KRON = (dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 1.5], ust=0.7, jh=0.1,
             jx=0.1, jp=0.1, xmu=0.2), (3, 2),
        np.array([[0.1, 0.04], [0.04, -0.1]]))


def _ops(kw, qn, h):
    jcfg = j_config(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    hloc = np.zeros((1, 1, jcfg.norb, jcfg.norb))
    hloc[0, 0] = h
    qn = ("n", (qn[0],), (qn[1],))
    jop = j_build_op(jcfg, JTable(jcfg).by_qn(qn), hloc, j_umatrix(jcfg),
                     j_init_bath(jcfg))
    op = build_normal_sector_op(cfg, SectorTable(cfg).by_qn(qn), hloc,
                                build_umatrix(cfg), init_bath(cfg))
    return jop, op, jcfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def fused32():
    jop, op, jcfg = _ops(*FUSED)
    jf = j_build_fused(jop, jcfg.norb)
    mv = fm.FusedKron(build_fused_normal(op, jcfg.norb), CPU,
                      dtype=torch.float32)
    return jop, jf, mv


def _padded_f32(jf, seed):
    v = np.random.default_rng(seed).normal(size=(jf.ddp, jf.dup))
    v[jf.dd:, :] = 0
    v[:, jf.du:] = 0
    return v.astype(np.float32)


def test_b2_operands_are_the_tpu_f32_tables(fused32):
    _, jf, mv = fused32
    ops = mv.ops
    assert ops.dtype == torch.float32 and ops.up_vals.dtype == torch.float32
    assert np.array_equal(ops.up_vals.numpy(), jf.up_vals)
    assert np.array_equal(ops.dw_vals.numpy(), jf.dw_vals)
    assert np.array_equal(ops.diag_a.numpy(), jf.diag_a)
    assert np.array_equal(ops.diag_b.numpy(), jf.diag_b)
    # the kernel reads them row-major, whatever the host arrays' strides
    assert all(t.is_contiguous() for t in (ops.up_vals, ops.dw_vals,
                                           ops.diag_a, ops.diag_b))


def test_b2_plain_vs_jax_oracle(fused32):
    _, jf, mv = fused32
    assert (mv.ops.nbu, mv.ops.nbd) == (2, 2) and len(jf.nl_runs) == 4
    v = _padded_f32(jf, 3)
    ref = jf.apply_ref(v.astype(np.float64))     # f32 tables, f64 sums
    v3 = torch.as_tensor(jf.to_blocked(v))
    before = (fm.launches, fm.launches_f32)
    out = fm.fused_matvec(v3, mv.ops)           # CPU tensor -> plain version
    assert (fm.launches, fm.launches_f32) == before
    assert out.dtype == torch.float32
    assert torch.equal(out, fm.fused_matvec_plain(v3, mv.ops))
    assert _rel(jf.from_blocked(out.numpy()), ref) <= RTOL_B2


def test_b2_plain_vs_jax_kron32(fused32):
    jop, jf, mv = fused32
    v = np.random.default_rng(4).normal(size=jf.dd * jf.du).astype(np.float32)
    ref = np.asarray(JKron(jop, dtype=jnp.float32)(jnp.asarray(v)))
    out = mv.from_internal_flat(mv(mv.to_internal_flat(torch.as_tensor(v))))
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= RTOL_B2


def test_b2_casts_like_jax_fusedkron(fused32):
    """An f64 vector through the f32 operator is computed in f32 and cast
    back (edipack_tpu's FusedKron.__call__)."""
    _, _, mv = fused32
    v = torch.as_tensor(np.random.default_rng(5).normal(size=mv.dim))
    v = mv.v0_project(v)
    out = mv(v)
    assert out.dtype == torch.float64 and mv.v0_project(v).dtype == v.dtype
    assert torch.equal(out, mv(v.float()).double())


def test_b3_plain_vs_jax_power_loop(fused32):
    _, jf, mv = fused32
    v = _padded_f32(jf, 3)
    K = 3
    power = fm.FusedPower(mv.fop, K, CPU)
    before = fm.power_launches
    w3, norms = power(torch.as_tensor(jf.to_blocked(v)))
    assert fm.power_launches == before
    assert norms.shape == (K,) and norms.dtype == torch.float32
    vv = v.astype(np.float64)
    for k in range(K):
        wk = jf.apply_ref(vv)
        nk = np.linalg.norm(wk)
        assert abs(float(norms[k]) - nk) / nk < TOL_B3
        vv = wk / nk
    w = jf.from_blocked(w3.numpy()).astype(np.float64)
    assert np.abs(w / np.linalg.norm(w) - vv).max() < TOL_B3


def test_fused_wrapper_dtype_checks(fused32):
    _, _, mv = fused32
    v3 = torch.zeros(mv.ops.nbu * mv.ops.ddp, 128, dtype=torch.float32)
    with pytest.raises(TypeError):
        fm.fused_matvec(v3.half(), mv.ops)
    with pytest.raises(TypeError):          # f64 input, f32 operands
        fm.fused_matvec(v3.double(), mv.ops)
    with pytest.raises(TypeError):
        fm.FusedOperands(mv.fop, CPU, torch.float16)
    with pytest.raises(ValueError):
        fm.fused_power(v3, mv.ops, 0)
    with pytest.raises(ValueError):         # not the column-blocked shape
        fm.fused_matvec(v3[:-1], mv.ops)


@pytest.fixture(scope="module")
def kron_sector():
    jop, op, _ = _ops(*KRON)
    v = np.random.default_rng(0).normal(size=op.sector.dim).astype(np.float32)
    return jop, op, v


def test_b4_plain_vs_jax_pallas_and_kron(kron_sector):
    from jax.experimental.pallas import tpu as pltpu
    from edipack_tpu.ops.pallas_kron import KronPallasMatvec
    jop, op, v = kron_sector
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(KronPallasMatvec(jop)(jnp.asarray(v)))
    want_kron = np.asarray(JKron(jop, dtype=jnp.float32)(jnp.asarray(v)))
    mv = kt.KronTileMatvec(op, CPU)
    assert (mv.dd, mv.du) == (op.hdw.shape[0], op.hup.shape[0])
    assert mv.dd * mv.du == mv.dim == op.sector.dim and mv.dd % 128
    assert mv.dtype == torch.float32 and mv.nnz == op.nnz_estimate()
    before = kt.launches
    got = mv(torch.as_tensor(v))
    assert kt.launches == before
    assert got.dtype == torch.float32 and got.shape == (op.sector.dim,)
    assert np.abs(got.numpy() - want_pallas).max() <= ATOL_B4
    assert np.abs(got.numpy() - want_kron).max() <= ATOL_B4


@pytest.mark.parametrize("case", ["kron", "fused"])
def test_b4_ell_plain_vs_dense(case, kron_sector):
    """B4's ELL plain version (what the wrapper runs on the CPU) against
    the dense formula, at the (3,2) sector and at the nbath=4 (5,4) one."""
    op = kron_sector[1] if case == "kron" else _ops(*FUSED)[1]
    mv = kt.KronTileMatvec(op, CPU)
    v = torch.as_tensor(np.random.default_rng(6).normal(
        size=(mv.dd, mv.du)).astype(np.float32))
    hup_t = torch.as_tensor(np.asarray(op.hup).T, dtype=torch.float32)
    hdw = torch.as_tensor(np.asarray(op.hdw), dtype=torch.float32)
    assert mv.up_idx.shape == (np.count_nonzero(op.hup, 1).max(), mv.du)
    before = kt.launches
    got = kt.kron_matvec_tiles(v, *mv.tables())
    assert kt.launches == before
    assert torch.equal(got, fm.ell_matvec_plain(v, *mv.tables()))
    want = kt.kron_matvec_tiles_plain(v, mv.d, hup_t, hdw)
    assert (got - want).abs().max() <= ATOL_B4


def test_b4_wrapper_checks(kron_sector):
    _, op, _ = kron_sector
    mv = kt.KronTileMatvec(op, CPU)
    d, up_idx, up_val, dw_idx, dw_val = mv.tables()
    v = torch.zeros(mv.dd, mv.du)
    with pytest.raises(TypeError):
        kt.kron_matvec_tiles(v.double(), *mv.tables())
    with pytest.raises(TypeError):
        kt.kron_matvec_tiles(v, d, up_idx.long(), up_val, dw_idx, dw_val)
    with pytest.raises(ValueError):
        kt.kron_matvec_tiles(v[:-1], d[:-1], up_idx, up_val, dw_idx, dw_val)
    with pytest.raises(ValueError):
        kt.kron_matvec_tiles(v.reshape(-1), *mv.tables())
    with pytest.raises(ValueError):
        kt.kron_matvec_tiles(v.t().contiguous().t(), *mv.tables())
    out = kt.kron_matvec_tiles(d, *mv.tables())
    assert torch.equal(out, fm.ell_matvec_plain(d, *mv.tables()))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_b2_kernel_vs_plain_on_card(fused32):
    dev = _card()
    _, jf, mv_cpu = fused32
    mv = fm.FusedKron(mv_cpu.fop, dev, dtype=torch.float32)
    v3 = torch.as_tensor(jf.to_blocked(_padded_f32(jf, 7)), device=dev)
    before = fm.launches_f32
    out = fm.fused_matvec(v3, mv.ops)
    torch.cuda.synchronize()
    assert fm.launches_f32 == before + 1
    ref = fm.fused_matvec_plain(v3, mv.ops)
    assert _rel(out.cpu().numpy(), ref.cpu().numpy()) <= RTOL_B2


@pytest.mark.cuda
def test_b3_kernel_vs_plain_on_card(fused32):
    dev = _card()
    _, jf, mv_cpu = fused32
    ops = fm.FusedOperands(mv_cpu.fop, dev, torch.float32)
    v3 = torch.as_tensor(jf.to_blocked(_padded_f32(jf, 8)), device=dev)
    before = fm.power_launches
    w3, norms = fm.fused_power(v3, ops, 8)
    torch.cuda.synchronize()
    assert fm.power_launches == before + 2 * 8    # a step and a finalize each
    w_ref, n_ref = fm.fused_power_plain(v3, ops, 8)
    assert (norms - n_ref).abs().max() / n_ref.abs().max() <= TOL_B3
    unit = lambda w: w / torch.linalg.norm(w)
    assert (unit(w3) - unit(w_ref)).abs().max() <= TOL_B3


@pytest.mark.cuda
def test_b4_kernel_vs_plain_on_card(kron_sector):
    """B4 on its ragged (15, 20) layout against its ELL plain version and
    the dense formula."""
    dev = _card()
    _, op, v = kron_sector
    mv = kt.KronTileMatvec(op, dev)
    v2 = torch.as_tensor(v, device=dev).view(mv.dd, mv.du)
    before = kt.launches
    out = kt.kron_matvec_tiles(v2, *mv.tables())
    torch.cuda.synchronize()
    assert kt.launches == before + 1
    ref = fm.ell_matvec_plain(v2, *mv.tables())
    dense = kt.kron_matvec_tiles_plain(
        v2, mv.d, torch.as_tensor(op.hup.T, dtype=torch.float32, device=dev),
        torch.as_tensor(op.hdw, dtype=torch.float32, device=dev))
    assert (out - ref).abs().max() <= ATOL_B4
    assert (out - dense).abs().max() <= ATOL_B4
