"""Sector-to-sector excitation-operator maps.

Parity target: reference ED_SECTOR.f90 apply_op_C/CDG (:465-1129),
re-expressed as precomputed gather maps (cf. edipack_tpu.ops.sector_ops):
in the factorized normal mode an operator c_{a,s} only permutes one spin
axis of ``V[DimPh, DimDw, DimUp]``, so its application is a single signed
axis-gather. Joint-basis (superc/nonsu2) operators are position maps over
the joint state list with full Jordan-Wigner signs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fock import apply_c, apply_cdg, state_index


@dataclass
class AxisOpMap:
    """Gather map along one spin axis: out[..., j] = sign[j] * in[..., src[j]]
    (src[j] = -1 -> zero). ``axis``: 2 = up, 1 = dw of the (ph, dw, up)
    tensor."""
    axis: int
    src: np.ndarray     # (dim_tgt,) int32 into the source axis
    sign: np.ndarray    # (dim_tgt,) float

    def apply(self, v3: torch.Tensor) -> torch.Tensor:
        src = torch.as_tensor(np.where(self.src < 0, 0, self.src),
                              dtype=torch.int64, device=v3.device)
        sign = torch.as_tensor(np.where(self.src < 0, 0.0, self.sign),
                               dtype=v3.dtype, device=v3.device)
        shape = [1, 1, 1]
        shape[self.axis] = -1
        return v3.index_select(self.axis, src) * sign.view(shape)


def spin_axis_op(basis_src: np.ndarray, basis_tgt: np.ndarray, ns: int,
                 kind: str, level: int, axis: int) -> AxisOpMap:
    """Map for c (kind='c') or c† (kind='cdg') at ``level`` acting on one spin
    species with per-spin JW signs (normal-mode convention)."""
    fn = apply_c if kind == "c" else apply_cdg
    new_states, signs, valid = fn(basis_src, level)
    # build target-side gather: for each target position, its source
    src = np.full(len(basis_tgt), -1, dtype=np.int64)
    sgn = np.zeros(len(basis_tgt))
    ok = np.nonzero(valid)[0]
    tgt_pos = state_index(basis_tgt, new_states[ok])
    good = tgt_pos >= 0
    src[tgt_pos[good]] = ok[good]
    sgn[tgt_pos[good]] = signs[ok[good]]
    return AxisOpMap(axis, src.astype(np.int32), sgn)


@dataclass
class JointOpMap:
    """Joint-basis operator map along the last axis:
    out[..., j] = sign[j] * in[..., src[j]] (src[j] = -1 -> zero)."""
    src: np.ndarray
    sign: np.ndarray

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        src = torch.as_tensor(np.where(self.src < 0, 0, self.src),
                              dtype=torch.int64, device=v.device)
        sign = torch.as_tensor(np.where(self.src < 0, 0.0, self.sign),
                               dtype=v.dtype, device=v.device)
        return v.index_select(v.dim() - 1, src) * sign


def joint_op(states_src: np.ndarray, states_tgt: np.ndarray, ns: int,
             kind: str, level: int, spin: int) -> JointOpMap:
    """c/c† at (level, spin) on the joint basis with full JW over the packed
    bitset (up bits 0..ns-1, dw bits ns..2ns-1)."""
    pos = level + spin * ns
    fn = apply_c if kind == "c" else apply_cdg
    new_states, signs, valid = fn(states_src, pos)
    src = np.full(len(states_tgt), -1, dtype=np.int64)
    sgn = np.zeros(len(states_tgt))
    ok = np.nonzero(valid)[0]
    tgt_pos = state_index(states_tgt, new_states[ok])
    good = tgt_pos >= 0
    src[tgt_pos[good]] = ok[good]
    sgn[tgt_pos[good]] = signs[ok[good]]
    return JointOpMap(src.astype(np.int32), sgn)
