"""edipack_tpu_torch's sector matvecs against edipack_tpu's: the dense-factor
KronMatvec, and the fused operator's plain PyTorch version (the CPU side of
the CUDA kernel) against the TPU package's NumPy oracle and f64 KronMatvec.
For float64 the plain version reads the ELL tables the kernel reads (B1,
the sparse row-gather kernel); it is also held to the block-table plain
version that B2 keeps. The kernel itself is compared with the plain version
on the card."""
import dataclasses

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

from edipack_tpu_torch.models.normal import build_normal_sector_op
from edipack_tpu_torch.ops import fused_matvec as fm
from edipack_tpu_torch.ops import _build
from edipack_tpu_torch.ops.fused_normal import (_block_compact,
                                                build_fused_normal)
from edipack_tpu_torch.ops.matvec import KronMatvec
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.umatrix import build_umatrix
from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.convert import config_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-12     # f64 products in another summation order
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
SECTORS = {
    "config1": (dict(norb=1, nbath=4, nspin=1), (2, 3)),
    "kanamori": (dict(norb=2, nbath=3, nspin=1, **KANAMORI), (4, 3)),
    "phonon": (dict(norb=1, nbath=1, nspin=1, uloc=[1.0], nph=3, w0_ph=0.7,
                    g_ph=[0.4], a_ph=0.1), (1, 1)),
}
# nbath=4 (5,4): nbu = nbd = 2, so the runs' source-block offsets and the
# lane shift (delta != 0) and its clipped branches are exercised
FUSED = (dict(norb=2, nbath=4, nspin=1, **KANAMORI), (5, 4))


def _ops(kw, qn):
    jcfg = j_config(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    hloc = np.zeros((1, 1, jcfg.norb, jcfg.norb))
    hloc[0, 0] = np.diag([0.1, -0.2][:jcfg.norb])
    qn = ("n", (qn[0],), (qn[1],))
    jop = j_build_op(jcfg, JTable(jcfg).by_qn(qn), hloc, j_umatrix(jcfg),
                     j_init_bath(jcfg))
    op = build_normal_sector_op(cfg, SectorTable(cfg).by_qn(qn), hloc,
                                build_umatrix(cfg), init_bath(cfg))
    return jop, op, jcfg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", sorted(SECTORS))
def test_kron_matvec_vs_jax(name):
    jop, op, _ = _ops(*SECTORS[name])
    v = np.random.default_rng(1).normal(size=op.sector.dim)
    ref = np.asarray(JKron(jop, dtype=jnp.float64)(jnp.asarray(v)))
    mv = KronMatvec(op, CPU)
    out = mv(torch.as_tensor(v)).numpy()
    assert mv.dim == op.sector.dim and mv.has_ph == (op.ph_mat is not None)
    assert _rel(out, ref) <= RTOL


def test_kron_matvec_dense_nonlocal_fallback():
    """Non-local factors given only as dense matrices (nl_a/nl_b, no
    permutation form) take the einsum branch."""
    jop, op, _ = _ops(*SECTORS["kanamori"])

    class DenseNl:
        def __init__(self, base):
            self.__dict__.update(vars(base))
            self.nl_a, self.nl_b = base.nl_a, base.nl_b
            # a row with two entries defeats the permutation decomposition
            self.nl_a = self.nl_a.copy()
            self.nl_a[0, 0, :2] += 0.01
            self.nl_perm = None

    dense = DenseNl(op)
    assert KronMatvec(dense, CPU).nl_dense is not None
    v = np.random.default_rng(2).normal(size=op.sector.dim)
    h = np.kron(op.hdw, np.eye(op.hup.shape[0])) \
        + np.kron(np.eye(op.hdw.shape[0]), op.hup) + np.diag(op.d.ravel())
    for a, b in zip(dense.nl_a, dense.nl_b):
        h += np.kron(b, a)
    out = KronMatvec(dense, CPU)(torch.as_tensor(v)).numpy()
    assert _rel(out, h @ v) <= RTOL


@pytest.fixture(scope="module")
def fused():
    jop, op, jcfg = _ops(*FUSED)
    jf = j_build_fused(jop, jcfg.norb)
    mv = fm.FusedKron(build_fused_normal(op, jcfg.norb), CPU)
    return jop, jf, mv


def test_fused_plain_vs_jax_oracle(fused):
    _, jf, mv = fused
    assert (mv.ops.nbu, mv.ops.nbd) == (2, 2) and len(jf.nl_runs) == 4
    assert any((r.su0 - r.du0) % 128 for r in jf.nl_runs)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(jf.ddp, jf.dup))
    v[jf.dd:, :] = 0
    v[:, jf.du:] = 0
    # the TPU package's NumPy oracle, fed its own f64 values (hi + lo)
    oracle = dataclasses.replace(
        jf, up_vals=jf.up_vals.astype(np.float64) + jf.up_vals_lo,
        dw_vals=jf.dw_vals.astype(np.float64) + jf.dw_vals_lo,
        diag_a=jf.diag_a64, diag_b=jf.diag_b64)
    ref = oracle.apply_ref(v)
    v3 = torch.as_tensor(jf.to_blocked(v))
    before = fm.launches
    out = fm.fused_matvec(v3, mv.ops)       # CPU tensor -> plain version
    assert fm.launches == before
    assert torch.equal(out, fm.fused_matvec_plain(v3, mv.ops))
    assert _rel(jf.from_blocked(out.numpy()), ref) <= 1e-12


@pytest.mark.parametrize("case", ["fused", "kanamori"])
def test_fused_ell_plain_vs_block_plain(case, fused):
    """B1's ELL plain version against the block products (B2's plain
    version) fed the same f64 values."""
    if case == "fused":
        jop, _, mv = fused
        fop = mv.fop
    else:
        jop, op, jcfg = _ops(*SECTORS["kanamori"])
        fop = build_fused_normal(op, jcfg.norb)
        mv = fm.FusedKron(fop, CPU)
    blk = fm.FusedOperands(fop, CPU, torch.float32)
    for name, h, perm, n in (("up_vals", jop.hup, fop.perm_up, fop.dup),
                             ("dw_vals", jop.hdw, fop.perm_dw, fop.ddp)):
        hp = np.zeros((n, n))
        hp[:len(perm), :len(perm)] = np.asarray(h)[np.ix_(perm, perm)]
        setattr(blk, name, torch.as_tensor(_block_compact(hp.T)[0]))
    blk.diag_a = torch.as_tensor(fop.diag_a64)
    blk.diag_b = torch.as_tensor(fop.diag_b64)
    blk.runs_v = blk.runs_v.double()
    v = torch.as_tensor(np.random.default_rng(8).normal(size=fop.dd * fop.du))
    v3 = mv.to_internal_flat(v).view(-1, 128)
    out = fm.fused_matvec_plain(v3, mv.ops)
    assert _rel(out.numpy(), fm.block_matvec_plain(v3, blk).numpy()) <= 1e-13


def test_fused_f64_cpu_takes_ell_plain(fused, monkeypatch):
    """A float64 CPU tensor goes through the ELL plain version: no kernel
    build, no launch, no block products."""
    _, _, mv = fused

    def refuse(*a, **k):
        raise AssertionError("not on this path")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(fm, "block_matvec_plain", refuse)
    v3 = mv.v0_project(torch.as_tensor(
        np.random.default_rng(9).normal(size=mv.dim))).view(-1, 128)
    before = fm.launches
    out = fm.fused_matvec(v3, mv.ops)
    assert fm.launches == before and out.dtype == torch.float64
    v2 = v3.view(mv.nbu, mv.ddp, 128).permute(1, 0, 2).reshape(mv.ddp, -1)
    w2 = fm.ell_matvec_plain(v2, mv.ops.diag_a @ mv.ops.diag_b.T,
                             mv.ops.up_idx, mv.ops.up_val, mv.ops.dw_idx,
                             mv.ops.dw_val)
    for rn in mv.ops.runs:
        w2[rn.dd0:rn.dd0 + rn.ld, rn.du0:rn.du0 + rn.lu] += \
            rn.val * v2[rn.sd0:rn.sd0 + rn.ld, rn.su0:rn.su0 + rn.lu]
    assert torch.equal(out, w2.view(mv.ddp, mv.nbu, 128).permute(1, 0, 2)
                       .reshape(-1, 128))


def test_fused_plain_vs_jax_kron(fused):
    jop, jf, mv = fused
    v = np.random.default_rng(4).normal(size=jf.dd * jf.du)
    ref = np.asarray(JKron(jop, dtype=jnp.float64)(jnp.asarray(v)))
    out = mv.from_internal_flat(mv(mv.to_internal_flat(torch.as_tensor(v))))
    assert _rel(out.numpy(), ref) <= RTOL


def test_fused_layout_roundtrip(fused):
    _, jf, mv = fused
    v = np.random.default_rng(5).normal(size=(jf.dd, jf.du))
    vi = mv.to_internal_flat(torch.as_tensor(v.ravel()))
    # same layout as the TPU package's NumPy converters
    assert np.array_equal(vi.numpy(), jf.to_blocked(jf.to_internal(v)).ravel())
    assert np.array_equal(mv.from_internal_flat(vi).numpy(), v.ravel())
    w = torch.as_tensor(np.random.default_rng(6).normal(size=mv.dim))
    assert torch.equal(mv.v0_project(w), mv.to_internal_flat(
        mv.from_internal_flat(w)))


def test_fused_wrapper_checks(fused):
    _, _, mv = fused
    v3 = torch.zeros(mv.ops.nbu * mv.ops.ddp, 128, dtype=torch.float64)
    with pytest.raises(TypeError):           # a dtype neither kernel takes
        fm.fused_matvec(v3.half(), mv.ops)
    with pytest.raises(ValueError):
        fm.fused_matvec(v3[:-1], mv.ops)
    with pytest.raises(ValueError):
        fm.fused_matvec(v3.t().contiguous().t(), mv.ops)


@pytest.mark.cuda
def test_fused_kernel_vs_plain_on_card(fused):
    """B1 against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    _, jf, mv_cpu = fused
    dev = torch.device("cuda")
    mv = fm.FusedKron(mv_cpu.fop, dev)
    v = torch.as_tensor(np.random.default_rng(7).normal(size=jf.dd * jf.du),
                        device=dev)
    v3 = mv.to_internal_flat(v).view(-1, 128)
    before = fm.launches
    out = fm.fused_matvec(v3, mv.ops)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    ref = fm.fused_matvec_plain(v3, mv.ops)
    assert _rel(out.cpu().numpy(), ref.cpu().numpy()) <= RTOL
