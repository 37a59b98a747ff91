"""Fused normal-sector matvec on the imp-MSB column-blocked layout, in f64
and f32, and the f32 chained power steps.

Counterpart of edipack_tpu.ops.pallas_fused. The TPU package has three
kernels here, which multiply the hop factors' nonzero blocks as dense
128×128 tiles; each has one CUDA counterpart, an instantiation of the
sparse row-gather kernel (``csrc/row_gather.cu``) that reads ELL tables of
the permuted hop factors (ops.fused_normal.build_fused_normal):

* B1, ``FusedMatvecDS`` wrapped by ``MixedFusedKron``: the TPU kernel
  computes H·V as double-single f32 planes; the card has native FP64, so
  here it is the f64 kernel;
* B2, ``FusedMatvec`` wrapped by ``FusedKron``: the same product in f32;
* B3, ``FusedPower``: ``niter`` chained steps w = H·v, v = w/‖w‖, on B2's
  pass with the scale and the sum of squares folded in.

* :func:`fused_matvec` — the matvec wrapper: for a CUDA tensor it launches
  B1 (float64) or B2 (float32), or raises; it runs
  :func:`fused_matvec_plain` only for a tensor on the CPU. Each launch adds
  one to the module counter ``launches`` (B1) or ``launches_f32`` (B2).
* :func:`fused_matvec_plain` — the same function in plain PyTorch, in the
  operands' dtype: the ELL gathers, one torch gather per slot
  (:func:`ell_matvec_plain`), then the Jx/Jp rectangle shifts.
* :class:`FusedKron` — the solver-facing operator on flat internal vectors,
  with the original <-> internal layout conversion.
* :class:`FusedPower` — B3; each call on the card adds its 2·niter kernel
  launches to ``power_launches``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DTYPE
from . import _build
from .fused_normal import BLK, FusedNormalOp

launches = 0          # B1 (f64) kernel launches since the last reset
launches_f32 = 0      # B2 (f32) kernel launches since the last reset
power_launches = 0    # B3 kernel launches (2 per step) since the last reset

_ENTRY = {torch.float64: "fused_normal_matvec_f64",
          torch.float32: "fused_normal_matvec_f32"}


class FusedOperands:
    """Device-resident operands of one sector's fused matvec in ``dtype``
    (float64: B1, float32: B2 and B3): the ELL tables of the permuted hop
    factors and the diagonal factors, cast to ``dtype`` at upload, and the
    runs."""

    def __init__(self, fop: FusedNormalOp, device: torch.device,
                 dtype: torch.dtype = DTYPE):
        if dtype not in _ENTRY:
            raise TypeError(f"fused operands: unsupported dtype {dtype}")
        self.dtype = dtype
        self.ddp, self.dup = fop.ddp, fop.dup
        self.nbu, self.nbd = fop.dup // BLK, fop.ddp // BLK

        def put(x, dt=dtype):          # the kernels read row-major tables
            return torch.as_tensor(x, dtype=dt, device=device).contiguous()

        self.up_idx = put(fop.up_ell_idx, torch.int32)
        self.up_val = put(fop.up_ell_val)
        self.dw_idx = put(fop.dw_ell_idx, torch.int32)
        self.dw_val = put(fop.dw_ell_val)
        self.diag_a = put(fop.diag_a)
        self.diag_b = put(fop.diag_b)
        # the kernel reads only the factors' leading nonzero columns
        used = np.flatnonzero(np.any(fop.diag_a != 0, axis=0)
                              & np.any(fop.diag_b != 0, axis=0))
        self.rank = int(used[-1]) + 1 if len(used) else 0
        runs = [(r.dd0, r.sd0, r.ld, r.du0, r.su0, r.lu) for r in fop.nl_runs]
        self.runs_i = put(np.asarray(runs, np.int32).reshape(-1, 6),
                          torch.int32)
        self.runs_v = put([r.val for r in fop.nl_runs])
        self.runs = list(fop.nl_runs)

    def args(self):
        """The C entry points' operand pointers and sizes, in their order."""
        return (self.up_idx.data_ptr(), self.up_val.data_ptr(),
                self.up_idx.shape[0], self.dw_idx.data_ptr(),
                self.dw_val.data_ptr(), self.dw_idx.shape[0],
                self.diag_a.data_ptr(), self.diag_b.data_ptr(), self.rank,
                self.runs_i.data_ptr(), self.runs_v.data_ptr(),
                len(self.runs), self.ddp, self.dup)


def _check(v3: torch.Tensor, ops: FusedOperands) -> None:
    if v3.dtype not in _ENTRY:
        raise TypeError(f"fused_matvec: expected float64 or float32, got "
                        f"{v3.dtype}")
    if v3.dtype != ops.dtype:
        raise TypeError(f"fused_matvec: {v3.dtype} input, {ops.dtype} "
                        f"operands")
    if tuple(v3.shape) != (ops.nbu * ops.ddp, BLK):
        raise ValueError(f"fused_matvec: expected shape "
                         f"{(ops.nbu * ops.ddp, BLK)}, got {tuple(v3.shape)}")
    if not v3.is_contiguous():
        raise ValueError("fused_matvec: input must be contiguous")
    if v3.device != ops.diag_a.device:
        raise ValueError(f"fused_matvec: input on {v3.device}, operands on "
                         f"{ops.diag_a.device}")
    if v3.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_matvec: unsupported device {v3.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_matvec(v3: torch.Tensor, ops: FusedOperands) -> torch.Tensor:
    """W3 = H·V3 on the column-blocked layout (nbu*ddp, 128), in v3's dtype
    (float64: B1, float32: B2). Raises for a sector whose one row of V
    does not fit in shared memory (padded up dimension above about 29k in
    f64, 58k in f32)."""
    global launches, launches_f32
    _check(v3, ops)
    if v3.device.type == "cpu":
        return fused_matvec_plain(v3, ops)
    lib = _build.load_library()
    name = _ENTRY[v3.dtype]
    w3 = torch.empty_like(v3)
    with torch.cuda.device(v3.device):
        err = getattr(lib, name)(v3.data_ptr(), w3.data_ptr(),
                                 *ops.args(), _stream(v3))
    _build.check(lib, err, f"{name} launch")
    if v3.dtype == torch.float64:
        launches += 1
    else:
        launches_f32 += 1
    return w3


def ell_matvec_plain(v2: torch.Tensor, diag: torch.Tensor,
                     up_idx: torch.Tensor, up_val: torch.Tensor,
                     dw_idx: torch.Tensor, dw_val: torch.Tensor
                     ) -> torch.Tensor:
    """D⊙V + V·Hupᵀ + Hdw·V on the 2-D (d, u) layout from the ELL tables of
    Hup and Hdw (slot-major, ``fused_normal.ell_table``), one gather per
    slot, summed in the row-gather kernel's order."""
    w = diag * v2
    for e in range(up_idx.shape[0]):
        w += up_val[e] * v2[:, up_idx[e]]
    for e in range(dw_idx.shape[0]):
        w += dw_val[e].unsqueeze(1) * v2[dw_idx[e]]
    return w


def _add_runs(w2: torch.Tensor, v2: torch.Tensor, ops: FusedOperands
              ) -> None:
    """The non-local Jx/Jp terms: rectangle shifts on the 2-D layout."""
    for rn in ops.runs:
        w2[rn.dd0:rn.dd0 + rn.ld, rn.du0:rn.du0 + rn.lu] += \
            rn.val * v2[rn.sd0:rn.sd0 + rn.ld, rn.su0:rn.su0 + rn.lu]


def fused_matvec_plain(v3: torch.Tensor, ops: FusedOperands) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_matvec` (same function, in the
    operands' dtype, from the same tables as the kernel)."""
    nbu, ddp = ops.nbu, ops.ddp
    v2 = v3.view(nbu, ddp, BLK).permute(1, 0, 2).reshape(ddp, nbu * BLK)
    w2 = ell_matvec_plain(v2, ops.diag_a @ ops.diag_b.T, ops.up_idx,
                          ops.up_val, ops.dw_idx, ops.dw_val)
    _add_runs(w2, v2, ops)
    return w2.view(ddp, nbu, BLK).permute(1, 0, 2).reshape(nbu * ddp, BLK)


def fused_power(v3: torch.Tensor, ops: FusedOperands, niter: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: ``niter`` chained steps from V3 (f32), normalization lazy.

    Returns (w3, norms): w3 is the un-normalized H·v of the last step,
    norms[k] = ‖H v_k‖ with v_0 = V3 and v_{k+1} = H v_k / ‖H v_k‖. For a
    CUDA tensor: one host call, 2*niter kernel launches on the current
    stream and no host synchronization."""
    global power_launches
    _check(v3, ops)
    if v3.dtype != torch.float32:
        raise TypeError(f"fused_power: expected float32, got {v3.dtype}")
    if niter < 1:
        raise ValueError(f"fused_power: niter must be >= 1, got {niter}")
    if v3.device.type == "cpu":
        return fused_power_plain(v3, ops, niter)
    lib = _build.load_library()
    bufs = (torch.empty_like(v3), torch.empty_like(v3))
    f32 = dict(dtype=torch.float32, device=v3.device)
    partials = torch.empty(ops.ddp, **f32)     # one per block of >= 1 row
    ssq = torch.ones(niter + 1, **f32)
    norms = torch.empty(niter, **f32)
    with torch.cuda.device(v3.device):
        err = lib.fused_normal_power_f32(
            v3.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), *ops.args(),
            partials.data_ptr(), ssq.data_ptr(), norms.data_ptr(), niter,
            _stream(v3))
    _build.check(lib, err, "fused_normal_power_f32 launch")
    power_launches += 2 * niter
    return bufs[(niter - 1) % 2], norms


def fused_power_plain(v3: torch.Tensor, ops: FusedOperands, niter: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_power` (the same loop)."""
    ssq = torch.ones((), dtype=v3.dtype, device=v3.device)
    norms = []
    w = v3
    for _ in range(niter):
        w = fused_matvec_plain(w, ops) * torch.rsqrt(ssq)
        ssq = (w * w).sum()
        norms.append(torch.sqrt(ssq))
    return w, torch.stack(norms)


class FusedKron:
    """Fused sector matvec on flat internal vectors (n_internal,).

    ``dtype`` float64 runs B1, float32 B2 (edipack_tpu's ``FusedKron``, in
    full FP32). A vector of another dtype is cast to ``dtype`` for the
    product and the result cast back, as edipack_tpu's
    ``FusedKron.__call__`` does.

    Drop-in for ops.matvec.KronMatvec in the Lanczos solvers, except that
    the vector space is the padded imp-MSB-blocked internal layout: use
    to_internal_flat / from_internal_flat at the boundaries. Padding slots
    are structurally zero; v0_project zeroes them in start vectors."""

    def __init__(self, fop: FusedNormalOp, device: torch.device,
                 dtype: torch.dtype = DTYPE):
        self.fop = fop
        self.device = device
        self.dim = fop.n_internal
        self.dtype = dtype
        self.nnz = fop.nnz
        self.n_calls = 0
        self.ops = FusedOperands(fop, device, dtype)
        self.dd, self.du = fop.dd, fop.du
        self.ddp, self.dup = fop.ddp, fop.dup
        self.nbu = fop.dup // BLK
        idx = dict(dtype=torch.int64, device=device)
        self._perm_dw = torch.as_tensor(fop.perm_dw, **idx)
        self._perm_up = torch.as_tensor(fop.perm_up, **idx)
        self._iperm_dw = torch.as_tensor(np.argsort(fop.perm_dw), **idx)
        self._iperm_up = torch.as_tensor(np.argsort(fop.perm_up), **idx)
        mask = torch.zeros(self.nbu, self.ddp, BLK, dtype=dtype, device=device)
        mask[:, :self.dd, :] = 1.0
        col = (torch.arange(self.dup, device=device) < self.du).to(dtype)
        self._mask = (mask * col.view(self.nbu, 1, BLK)).reshape(-1)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        w = fused_matvec(v.reshape(-1, BLK).to(self.dtype), self.ops)
        return w.reshape(-1).to(v.dtype)

    def v0_project(self, v: torch.Tensor) -> torch.Tensor:
        return v * self._mask.to(v.dtype)

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


class FusedPower:
    """``niter`` chained (matvec + normalize) steps, f32: edipack_tpu's
    ``FusedPower``. ``__call__(v3) -> (w3, norms)`` on the column-blocked
    layout; see :func:`fused_power`."""

    def __init__(self, fop: FusedNormalOp, niter: int, device: torch.device):
        self.fop = fop
        self.niter = niter
        self.ops = FusedOperands(fop, device, torch.float32)

    def __call__(self, v3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return fused_power(v3, self.ops, self.niter)
