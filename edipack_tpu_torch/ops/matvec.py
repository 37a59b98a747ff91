"""Dense-factor Kronecker matvec of a normal-mode sector.

The sector vector is a dense tensor ``V[DimPh, DimDw, DimUp]``; H·V is a few
dense matmuls on the spin-factor matrices plus signed-permutation gathers
for the non-local terms (cf. edipack_tpu.ops.matvec.KronMatvec, which leaves
the same products to XLA). This is the path for sectors below the fused
kernel's size, for phonon sectors, and for ``ed_fused_matvec="never"``, in
the solve's working dtype (f64, or f32 for ``ed_precision="float32"``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DTYPE
from ..models.normal import NormalSectorOp


def _perm_factor(mats: np.ndarray):
    """Decompose a stack of ≤1-nnz-per-row matrices (signed partial
    permutations — every c/c† operator-string Kron factor has this form)
    into (src, sign) arrays; returns None if any row has >1 nnz."""
    k, nrow, _ = mats.shape
    src = np.zeros((k, nrow), dtype=np.int64)
    sgn = np.zeros((k, nrow), dtype=mats.dtype)
    for i in range(k):
        rows, cols = np.nonzero(mats[i])
        if len(np.unique(rows)) != len(rows):
            return None
        src[i, rows] = cols
        sgn[i, rows] = mats[i, rows, cols]
    return src, sgn


class NonLocal:
    """The non-local Kronecker terms Σ_k B_k@V@A_kᵀ of a sector operator.

    The factors are signed partial permutations, applied as two chained
    axis gathers and a rank-1 sign mask; a factor stack that is not of that
    form is kept dense (``dense``) and applied by an einsum."""

    def __init__(self, op: NormalSectorOp, put, put_idx):
        self.perm = None         # (src_a, sgn_a, src_b, sgn_b)
        self.dense = None        # (nl_b, nl_a^T) stacks
        if op.nl_perm is not None:
            src_a, sgn_a, src_b, sgn_b = op.nl_perm
            self.perm = (put_idx(src_a), put(sgn_a), put_idx(src_b),
                         put(sgn_b))
        elif getattr(op, "nl_a", None) is not None:
            pa = _perm_factor(op.nl_a)
            pb = _perm_factor(op.nl_b)
            if pa is not None and pb is not None:
                self.perm = (put_idx(pa[0]), put(pa[1]), put_idx(pb[0]),
                             put(pb[1]))
            else:
                self.dense = (put(op.nl_b), put(np.swapaxes(op.nl_a, 1, 2)))

    def add_to(self, out: torch.Tensor, v: torch.Tensor) -> None:
        """out += Σ_k B_k@V@A_kᵀ on the (DimPh, DimDw, DimUp) form."""
        if self.perm is not None:
            src_a, sgn_a, src_b, sgn_b = self.perm
            for k in range(src_a.shape[0]):
                t = v.index_select(1, src_b[k]).index_select(2, src_a[k])
                out += t * (sgn_b[k][None, :, None] * sgn_a[k][None, None, :])
        elif self.dense is not None:
            nl_b, nl_at = self.dense
            out += torch.einsum("kde,peu,kuv->pdv", nl_b, v, nl_at)

    def to(self, dtype: torch.dtype) -> "NonLocal":
        out = NonLocal.__new__(NonLocal)
        out.perm = None if self.perm is None else tuple(
            t.to(dtype) if t.is_floating_point() else t for t in self.perm)
        out.dense = None if self.dense is None else tuple(
            t.to(dtype) for t in self.dense)
        return out


class KronMatvec:
    """H·V = D⊙V + V@Hupᵀ + Hdw@V + Σ_k B_k@V@A_kᵀ (+ phonon terms).

    ``dtype`` is the operator's dtype (edipack_tpu's
    ``KronMatvec(op, dtype=...)``). A vector of another dtype is computed
    in the promoted dtype, as JAX promotes mixed operands: an f64 vector
    through the f32 operator runs in f64 on the f32-rounded factors."""

    def __init__(self, op: NormalSectorOp, device: torch.device,
                 dtype: torch.dtype = DTYPE):
        self.shape3 = (op.sector.dim_ph, op.hdw.shape[0], op.hup.shape[0])
        self.dim = int(np.prod(self.shape3))
        self.dtype = dtype
        self.device = device
        self.n_calls = 0

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        def put_idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        self.d = put(op.d)
        self.hup_t = put(op.hup.T)
        self.hdw = put(op.hdw)
        self.nl = NonLocal(op, put, put_idx)
        self.ph = None
        if op.ph_mat is not None:
            self.ph = (put(op.ph_mat), put(op.ph_x), put(op.eph_d),
                       put(op.eph_up.T), put(op.eph_dw))
        self._promoted = {}      # dtype -> operand copies (mixed operands)

    @property
    def has_ph(self) -> bool:
        return self.ph is not None

    @property
    def nl_dense(self):
        return self.nl.dense

    def _operands(self, dtype: torch.dtype):
        if dtype == self.dtype:
            return self.d, self.hup_t, self.hdw, self.nl, self.ph
        if dtype not in self._promoted:
            self._promoted[dtype] = (
                self.d.to(dtype), self.hup_t.to(dtype), self.hdw.to(dtype),
                self.nl.to(dtype),
                None if self.ph is None else tuple(t.to(dtype)
                                                   for t in self.ph))
        return self._promoted[dtype]

    def apply3(self, v: torch.Tensor) -> torch.Tensor:
        """Matvec on the (DimPh, DimDw, DimUp) tensor form."""
        dtype = torch.promote_types(v.dtype, self.dtype)
        v = v.to(dtype)
        d, hup_t, hdw, nl, ph = self._operands(dtype)
        out = d * v
        out += v @ hup_t
        out += torch.matmul(hdw, v)
        nl.add_to(out, v)
        if ph is not None:
            ph_mat, ph_x, eph_d, eph_up_t, eph_dw = ph
            out += torch.einsum("pq,qdu->pdu", ph_mat, v)
            ev = eph_d * v + v @ eph_up_t + torch.matmul(eph_dw, v)
            out += torch.einsum("pq,qdu->pdu", ph_x, ev)
        return out

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        return self.apply3(v.reshape(self.shape3)).reshape(-1)
