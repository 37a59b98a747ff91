"""Kronecker sector matvec in f32 through a sparse row-gather kernel (B4).

Counterpart of edipack_tpu.ops.pallas_kron: ``out = D⊙V + V·Hupᵀ + Hdw·V``
on the spin factors of a phonon-free normal sector. The TPU kernel
multiplies the dense factors as 128×128 tiles; here the factors are ELL
tables of their nonzeros (``fused_normal.ell_table``, in the original basis
order) and ``csrc/row_gather.cu`` gathers them, on the unpadded (dd, du)
layout, masking its own ragged edge. D stays dense, as in the TPU kernel.

* :func:`kron_matvec_tiles` — the kernel wrapper: launches the CUDA kernel
  for CUDA tensors (or raises) and runs its plain PyTorch version,
  ``fused_matvec.ell_matvec_plain`` on the same tables, only for tensors on
  the CPU. Each launch adds one to ``launches``.
* :func:`kron_matvec_tiles_plain` — the dense formula, the reference the
  kernel and its plain version are held to.
* :class:`KronTileMatvec` — the operator on flat sector vectors
  (edipack_tpu's ``KronPallasMatvec``): adds the non-local terms outside
  the kernel, as the TPU package does, through the signed-permutation
  gathers of ops.matvec (the same function without a dense ``nl_a``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .fused_matvec import ell_matvec_plain
from .fused_normal import ell_table
from .matvec import NonLocal

launches = 0         # kernel launches since the counter was last reset


def _check(v, d, up_idx, up_val, dw_idx, dw_val) -> None:
    if v.dim() != 2 or v.shape[0] <= 0 or v.shape[1] <= 0:
        raise ValueError(f"kron_matvec_tiles: V must be 2-D and not empty, "
                         f"got {tuple(v.shape)}")
    dd, du = v.shape
    want = {"v": (v, torch.float32, (dd, du)),
            "d": (d, torch.float32, (dd, du)),
            "up_idx": (up_idx, torch.int32, (up_idx.shape[0], du)),
            "up_val": (up_val, torch.float32, tuple(up_idx.shape)),
            "dw_idx": (dw_idx, torch.int32, (dw_idx.shape[0], dd)),
            "dw_val": (dw_val, torch.float32, tuple(dw_idx.shape))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"kron_matvec_tiles: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.dim() != len(shape) or tuple(t.shape) != shape:
            raise ValueError(f"kron_matvec_tiles: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"kron_matvec_tiles: {name} must be contiguous")
        if t.device != v.device:
            raise ValueError(f"kron_matvec_tiles: {name} on {t.device}, V on "
                             f"{v.device}")
    if v.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kron_matvec_tiles: unsupported device {v.device}")


def kron_matvec_tiles(v: torch.Tensor, d: torch.Tensor, up_idx: torch.Tensor,
                      up_val: torch.Tensor, dw_idx: torch.Tensor,
                      dw_val: torch.Tensor) -> torch.Tensor:
    """out = D⊙V + V·Hupᵀ + Hdw·V; V, D (dd, du) f32; (up_idx, up_val) the
    ELL table of Hup (width, du), (dw_idx, dw_val) of Hdw (width, dd), int32
    and f32. Raises for a sector whose one row of V does not fit in shared
    memory (du above about 58k)."""
    global launches
    _check(v, d, up_idx, up_val, dw_idx, dw_val)
    if v.device.type == "cpu":
        return ell_matvec_plain(v, d, up_idx, up_val, dw_idx, dw_val)
    lib = _build.load_library()
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.kron_tiles_matvec_f32(
            v.data_ptr(), d.data_ptr(), up_idx.data_ptr(), up_val.data_ptr(),
            up_idx.shape[0], dw_idx.data_ptr(), dw_val.data_ptr(),
            dw_idx.shape[0], out.data_ptr(), v.shape[0], v.shape[1], stream)
    _build.check(lib, err, "kron_tiles_matvec_f32 launch")
    launches += 1
    return out


def kron_matvec_tiles_plain(v: torch.Tensor, d: torch.Tensor,
                            hup_t: torch.Tensor, hdw: torch.Tensor
                            ) -> torch.Tensor:
    """The same function from the dense factors Hupᵀ and Hdw: the
    reference the kernel and its plain version are held to."""
    return d * v + v @ hup_t + hdw @ v


class KronTileMatvec:
    """f32 matvec of a phonon-free normal sector through the row-gather
    kernel, on flat (dd*du,) vectors in the original basis order."""

    def __init__(self, op, device: torch.device):
        if op.ph_mat is not None:
            raise ValueError("KronTileMatvec: phonon sectors are not supported")
        dd, du = op.hdw.shape[0], op.hup.shape[0]
        self.dd, self.du = dd, du
        self.dim = dd * du
        self.dtype = torch.float32
        self.device = device
        self.nnz = op.nnz_estimate()
        self.n_calls = 0
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.d = torch.as_tensor(op.d.reshape(dd, du), **f32).contiguous()
        up_idx, up_val = ell_table(op.hup)
        dw_idx, dw_val = ell_table(op.hdw)
        self.up_idx = torch.as_tensor(up_idx, **i32)
        self.up_val = torch.as_tensor(up_val, **f32)
        self.dw_idx = torch.as_tensor(dw_idx, **i32)
        self.dw_val = torch.as_tensor(dw_val, **f32)
        self.nl = NonLocal(
            op, lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                          dtype=torch.float32, device=device),
            lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device))

    def tables(self):
        """The kernel's operands after V: D and the two ELL tables."""
        return self.d, self.up_idx, self.up_val, self.dw_idx, self.dw_val

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        v2 = v.reshape(self.dd, self.du).to(torch.float32).contiguous()
        out = kron_matvec_tiles(v2, *self.tables())
        self.nl.add_to(out.view(1, self.dd, self.du),
                       v2.view(1, self.dd, self.du))
        return out.reshape(-1)
