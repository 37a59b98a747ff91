"""Fused f64 normal-sector matvec on the imp-MSB column-blocked layout.

Counterpart of edipack_tpu.ops.pallas_fused (``FusedMatvecDS`` wrapped by
``MixedFusedKron``). The TPU kernel computes H·V as double-single f32
planes; the card has native FP64, so here the product is one f64 kernel,
``csrc/fused_normal.cu``, with the same operator metadata
(ops.fused_normal.build_fused_normal).

* :func:`fused_matvec` — the kernel wrapper: launches the CUDA kernel for a
  CUDA tensor (or raises), and runs :func:`fused_matvec_plain` only for a
  tensor on the CPU. Each launch adds one to the module counter
  ``launches``.
* :func:`fused_matvec_plain` — the same function in plain PyTorch
  (gathered source blocks and one matmul per column / row block, then the
  rectangle shifts of the non-local terms).
* :class:`FusedKron` — the solver-facing operator on flat internal vectors,
  with the original <-> internal layout conversion.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DTYPE
from . import _build
from .fused_normal import BLK, DIAG_RANK, FusedNormalOp

launches = 0     # kernel launches since the counter was last reset


class FusedOperands:
    """Device-resident operands of one sector's fused matvec."""

    def __init__(self, fop: FusedNormalOp, device: torch.device):
        self.ddp, self.dup = fop.ddp, fop.dup
        self.nbu, self.nbd = fop.dup // BLK, fop.ddp // BLK
        f64 = dict(dtype=DTYPE, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.up_vals = torch.as_tensor(fop.up_vals64, **f64).contiguous()
        self.dw_vals = torch.as_tensor(fop.dw_vals64, **f64).contiguous()
        self.up_src = torch.as_tensor(fop.up_src, **i32)
        self.dw_src = torch.as_tensor(fop.dw_src, **i32)
        self.up_ptr = torch.as_tensor(fop.up_ptr, **i32)
        self.dw_ptr = torch.as_tensor(fop.dw_ptr, **i32)
        self.diag_a = torch.as_tensor(fop.diag_a64, **f64).contiguous()
        self.diag_b = torch.as_tensor(fop.diag_b64, **f64).contiguous()
        runs = [(r.dd0, r.sd0, r.ld, r.du0, r.su0, r.lu) for r in fop.nl_runs]
        self.runs_i = torch.as_tensor(np.asarray(runs, np.int32).reshape(-1, 6),
                                      **i32)
        self.runs_v = torch.as_tensor([r.val for r in fop.nl_runs], **f64)
        # host copies for the plain version's loops
        self.runs = list(fop.nl_runs)
        self.up_ptr_h = [int(x) for x in fop.up_ptr]
        self.dw_ptr_h = [int(x) for x in fop.dw_ptr]
        self.up_src_l = self.up_src.long()
        self.dw_src_l = self.dw_src.long()


def _check(v3: torch.Tensor, ops: FusedOperands) -> None:
    if v3.dtype != DTYPE:
        raise TypeError(f"fused_matvec: expected float64, got {v3.dtype}")
    if tuple(v3.shape) != (ops.nbu * ops.ddp, BLK):
        raise ValueError(f"fused_matvec: expected shape "
                         f"{(ops.nbu * ops.ddp, BLK)}, got {tuple(v3.shape)}")
    if not v3.is_contiguous():
        raise ValueError("fused_matvec: input must be contiguous")
    if v3.device != ops.up_vals.device:
        raise ValueError(f"fused_matvec: input on {v3.device}, operands on "
                         f"{ops.up_vals.device}")


def fused_matvec(v3: torch.Tensor, ops: FusedOperands) -> torch.Tensor:
    """W3 = H·V3 on the column-blocked layout (nbu*ddp, 128), f64."""
    global launches
    _check(v3, ops)
    if v3.device.type == "cpu":
        return fused_matvec_plain(v3, ops)
    if v3.device.type != "cuda":
        raise RuntimeError(f"fused_matvec: unsupported device {v3.device}")
    lib = _build.load_library()
    w3 = torch.empty_like(v3)
    with torch.cuda.device(v3.device):
        stream = torch.cuda.current_stream(v3.device).cuda_stream
        err = lib.fused_normal_matvec_f64(
            v3.data_ptr(), w3.data_ptr(),
            ops.up_vals.data_ptr(), ops.up_src.data_ptr(),
            ops.up_ptr.data_ptr(), ops.dw_vals.data_ptr(),
            ops.dw_src.data_ptr(), ops.dw_ptr.data_ptr(),
            ops.diag_a.data_ptr(), ops.diag_b.data_ptr(),
            ops.runs_i.data_ptr(), ops.runs_v.data_ptr(),
            len(ops.runs), ops.ddp, ops.nbu, ops.nbd, stream)
    _build.check(lib, err, "fused_normal_matvec_f64 launch")
    launches += 1
    return w3


def fused_matvec_plain(v3: torch.Tensor, ops: FusedOperands) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_matvec` (same function)."""
    nbu, nbd, ddp = ops.nbu, ops.nbd, ops.ddp
    v = v3.view(nbu, ddp, BLK)
    # diagonal from its rank-8 factors: D[j, d, c] = a[d] . b[j*BLK + c]
    w = torch.einsum("dk,jck->jdc", ops.diag_a,
                     ops.diag_b.view(nbu, BLK, DIAG_RANK)) * v
    # up factor: per column block j, one large-K matmul over its gathered
    # source column blocks
    for j in range(nbu):
        lo, hi = ops.up_ptr_h[j], ops.up_ptr_h[j + 1]
        if hi > lo:
            g = v.index_select(0, ops.up_src_l[lo:hi])          # (n, ddp, BLK)
            g = g.permute(1, 0, 2).reshape(ddp, (hi - lo) * BLK)
            w[j] += g @ ops.up_vals[lo:hi].reshape((hi - lo) * BLK, BLK)
    # dw factor: per 128-row block r, all column blocks at once
    vb = v.view(nbu, nbd, BLK, BLK)
    wb = w.view(nbu, nbd, BLK, BLK)
    for r in range(nbd):
        lo, hi = ops.dw_ptr_h[r], ops.dw_ptr_h[r + 1]
        if hi > lo:
            a = ops.dw_vals[lo:hi].permute(2, 0, 1).reshape(BLK, (hi - lo) * BLK)
            g = vb.index_select(1, ops.dw_src_l[lo:hi])   # (nbu, n, BLK, BLK)
            wb[:, r] += a @ g.reshape(nbu, (hi - lo) * BLK, BLK)
    if not ops.runs:
        return w.view(nbu * ddp, BLK)
    # non-local Jx/Jp terms: rectangle shifts on the 2D (ddp, dup) layout
    w2 = w.permute(1, 0, 2).reshape(ddp, nbu * BLK)
    v2 = v.permute(1, 0, 2).reshape(ddp, nbu * BLK)
    for rn in ops.runs:
        w2[rn.dd0:rn.dd0 + rn.ld, rn.du0:rn.du0 + rn.lu] += \
            rn.val * v2[rn.sd0:rn.sd0 + rn.ld, rn.su0:rn.su0 + rn.lu]
    return w2.view(ddp, nbu, BLK).permute(1, 0, 2).reshape(nbu * ddp, BLK)


class FusedKron:
    """f64 fused sector matvec on flat internal vectors (n_internal,).

    Drop-in for ops.matvec.KronMatvec in the Lanczos solvers, except that
    the vector space is the padded imp-MSB-blocked internal layout: use
    to_internal_flat / from_internal_flat at the boundaries. Padding slots
    are structurally zero; v0_project zeroes them in start vectors."""

    def __init__(self, fop: FusedNormalOp, device: torch.device):
        self.fop = fop
        self.device = device
        self.dim = fop.n_internal
        self.dtype = DTYPE
        self.nnz = fop.nnz
        self.n_calls = 0
        self.ops = FusedOperands(fop, device)
        self.dd, self.du = fop.dd, fop.du
        self.ddp, self.dup = fop.ddp, fop.dup
        self.nbu = fop.dup // BLK
        idx = dict(dtype=torch.int64, device=device)
        self._perm_dw = torch.as_tensor(fop.perm_dw, **idx)
        self._perm_up = torch.as_tensor(fop.perm_up, **idx)
        self._iperm_dw = torch.as_tensor(np.argsort(fop.perm_dw), **idx)
        self._iperm_up = torch.as_tensor(np.argsort(fop.perm_up), **idx)
        mask = torch.zeros(self.nbu, self.ddp, BLK, dtype=DTYPE, device=device)
        mask[:, :self.dd, :] = 1.0
        col = (torch.arange(self.dup, device=device) < self.du).to(DTYPE)
        self._mask = (mask * col.view(self.nbu, 1, BLK)).reshape(-1)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        return fused_matvec(v.reshape(-1, BLK), self.ops).reshape(-1)

    def v0_project(self, v: torch.Tensor) -> torch.Tensor:
        return v * self._mask

    def to_internal_flat(self, v_orig: torch.Tensor) -> torch.Tensor:
        """Original (dd*du,) -> padded internal layout: two axis gathers, a
        pad and a transpose."""
        v2 = v_orig.reshape(self.dd, self.du)
        v2 = v2.index_select(0, self._perm_dw).index_select(1, self._perm_up)
        vp = torch.zeros(self.ddp, self.dup, dtype=v2.dtype, device=v2.device)
        vp[:self.dd, :self.du] = v2
        return vp.view(self.ddp, self.nbu, BLK).permute(1, 0, 2).reshape(-1)

    def from_internal_flat(self, v_int: torch.Tensor) -> torch.Tensor:
        x = v_int.view(self.nbu, self.ddp, BLK).permute(1, 0, 2) \
            .reshape(self.ddp, self.dup)[:self.dd, :self.du]
        x = x.index_select(0, self._iperm_dw).index_select(1, self._iperm_up)
        return x.reshape(-1)
