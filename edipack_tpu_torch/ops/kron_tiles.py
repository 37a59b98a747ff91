"""Dense-tile Kronecker sector matvec in f32 (kernel B4).

Counterpart of edipack_tpu.ops.pallas_kron: ``out = D⊙V + V·Hupᵀ + Hdw·V``
on the dense spin factors of a phonon-free normal sector, 128×128 output
tiles, in ``csrc/kron_tiles.cu``.

* :func:`kron_matvec_tiles` — the kernel wrapper: launches the CUDA kernel
  for CUDA tensors (or raises) and runs :func:`kron_matvec_tiles_plain`
  only for tensors on the CPU. Each launch adds one to ``launches``.
* :class:`KronTileMatvec` — the operator on flat sector vectors
  (edipack_tpu's ``KronPallasMatvec``): zero-pads V to the kernel's tile and
  adds the non-local terms outside the kernel, as the TPU package does,
  through the signed-permutation gathers of ops.matvec (the same function
  without a dense ``nl_a``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .matvec import NonLocal

BLK = 128            # the kernel's output tile edge
launches = 0         # kernel launches since the counter was last reset


def _check(v, d, hup_t, hdw) -> None:
    ddp, dup = v.shape if v.dim() == 2 else (-1, -1)
    want = {"v": (v, (ddp, dup)), "d": (d, (ddp, dup)),
            "hup_t": (hup_t, (dup, dup)), "hdw": (hdw, (ddp, ddp))}
    if ddp % BLK or dup % BLK or ddp <= 0 or dup <= 0:
        raise ValueError(f"kron_matvec_tiles: V must be 2-D with sides that "
                         f"are multiples of {BLK}, got {tuple(v.shape)}")
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32:
            raise TypeError(f"kron_matvec_tiles: {name} must be float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"kron_matvec_tiles: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"kron_matvec_tiles: {name} must be contiguous")
        if t.device != v.device:
            raise ValueError(f"kron_matvec_tiles: {name} on {t.device}, V on "
                             f"{v.device}")
    if v.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kron_matvec_tiles: unsupported device {v.device}")


def kron_matvec_tiles(v: torch.Tensor, d: torch.Tensor, hup_t: torch.Tensor,
                      hdw: torch.Tensor) -> torch.Tensor:
    """out = D⊙V + V·Hupᵀ + Hdw·V; V, D (ddp, dup), Hupᵀ (dup, dup), Hdw
    (ddp, ddp), f32, ddp and dup multiples of 128."""
    global launches
    _check(v, d, hup_t, hdw)
    if v.device.type == "cpu":
        return kron_matvec_tiles_plain(v, d, hup_t, hdw)
    lib = _build.load_library()
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.kron_tiles_matvec_f32(
            v.data_ptr(), d.data_ptr(), hup_t.data_ptr(), hdw.data_ptr(),
            out.data_ptr(), v.shape[0], v.shape[1], stream)
    _build.check(lib, err, "kron_tiles_matvec_f32 launch")
    launches += 1
    return out


def kron_matvec_tiles_plain(v: torch.Tensor, d: torch.Tensor,
                            hup_t: torch.Tensor, hdw: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version of :func:`kron_matvec_tiles`."""
    return d * v + v @ hup_t + hdw @ v


class KronTileMatvec:
    """f32 matvec of a phonon-free normal sector through the dense-tile
    kernel, on flat (dd*du,) vectors in the original basis order."""

    def __init__(self, op, device: torch.device):
        if op.ph_mat is not None:
            raise ValueError("KronTileMatvec: phonon sectors are not supported")
        dd, du = op.hdw.shape[0], op.hup.shape[0]
        self.dd0, self.du0 = dd, du
        self.ddp = -(-dd // BLK) * BLK
        self.dup = -(-du // BLK) * BLK
        self.dim = dd * du
        self.dtype = torch.float32
        self.device = device
        self.nnz = op.nnz_estimate()
        self.n_calls = 0

        def padded(x, shape):
            out = np.zeros(shape, np.float32)
            out[:x.shape[0], :x.shape[1]] = x
            return torch.as_tensor(out, device=device)

        self.d = padded(op.d.reshape(dd, du), (self.ddp, self.dup))
        self.hup_t = padded(op.hup.T, (self.dup, self.dup))
        self.hdw = padded(op.hdw, (self.ddp, self.ddp))
        self.nl = NonLocal(
            op, lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                          dtype=torch.float32, device=device),
            lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device))

    def pad(self, v: torch.Tensor) -> torch.Tensor:
        vp = torch.zeros(self.ddp, self.dup, dtype=torch.float32,
                         device=v.device)
        vp[:self.dd0, :self.du0] = v.reshape(self.dd0, self.du0)
        return vp

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        out = kron_matvec_tiles(self.pad(v), self.d, self.hup_t, self.hdw)
        out = out[:self.dd0, :self.du0].contiguous()
        self.nl.add_to(out.view(1, self.dd0, self.du0),
                       v.reshape(1, self.dd0, self.du0).to(torch.float32))
        return out.reshape(-1)
