"""Sector matvecs in PyTorch (cf. edipack_tpu.ops.matvec).

* :class:`KronMatvec` — a normal-mode sector: the sector vector is a dense
  tensor ``V[DimPh, DimDw, DimUp]``; H·V is a few dense matmuls on the
  spin-factor matrices plus signed-permutation gathers for the non-local
  terms. This is the path for sectors below the fused kernel's size, for
  phonon sectors, and for ``ed_fused_matvec="never"``, in the solve's
  working dtype (f64, or f32 for ``ed_precision="float32"``).
* :class:`EllMatvec`, :class:`JointMatvec`, :class:`JointMatvecDirect` — a
  superc / nonsu2 joint sector in complex128: the padded-ELL row gather of
  the electronic H (the stored operator, ``ed_sparse_h=True``) or a
  scatter-add of its COO terms (``ed_sparse_h=False``), batched over the
  phonon axis, plus the phonon and electron-phonon Kronecker terms. Both
  process the rows (or terms) in chunks, so that the gathered temporary
  stays under ``CHUNK_ELEMS`` elements whatever the sector's size.

Each of these operators takes a flat vector (dim,) or a (B, dim) block of
B vectors in one call (``batched``; ``n_calls`` counts calls, not rows):
the GF chains into one target sector run through it together
(ops.lanczos.lanczos_tridiag_batch).

Split over the ranks of a mesh (parallel.mesh; the JAX package's
``shard_kron_matvec`` / ``shard_joint_matvec``):

* :class:`ShardedKronMatvec` — the dw rows of V[ph, dw, up]: ``V·Hupᵀ``
  and the phonon-axis terms stay local, ``Hdw[rows]·V`` and the non-local
  terms read the gathered V;
* :class:`ShardedJointMatvec` — the electronic rows of the padded-ELL
  tables (and of the e-ph ELL); v is gathered before the contraction, the
  phonon operators stay whole.

Their vectors are this rank's rows (``local`` slices a whole vector or
block, ``gather`` rebuilds it; ``dim`` stays the whole sector's).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DTYPE
from ..models.joint import JointSectorOp
from ..models.normal import NormalSectorOp
from ..parallel.mesh import Mesh, RowShard

CDTYPE = torch.complex128
# elements of the gathered (rows, K) / (terms,) temporaries of the joint
# matvecs: 2^24 complex128 = 256 MiB
CHUNK_ELEMS = 1 << 24


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

    def add_to(self, out: torch.Tensor, v: torch.Tensor, rows=None) -> None:
        """out += Σ_k B_k@V@A_kᵀ on the (..., DimPh, DimDw, DimUp) form;
        ``rows = (lo, hi)``: only those dw rows of it (``out``'s), from the
        whole ``v``."""
        r = slice(None) if rows is None else slice(*rows)
        if self.perm is not None:
            src_a, sgn_a, src_b, sgn_b = self.perm
            for k in range(src_a.shape[0]):
                t = v.index_select(-2, src_b[k][r]).index_select(-1, src_a[k])
                out += t * (sgn_b[k][r, None] * sgn_a[k][None, :])
        elif self.dense is not None:
            nl_b, nl_at = self.dense
            out += torch.einsum("kde,...peu,kuv->...pdv", nl_b[:, r], v,
                                nl_at)

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

    batched = True

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

    def apply3(self, v: torch.Tensor, rows=None, full=None) -> torch.Tensor:
        """Matvec on the (..., DimPh, DimDw, DimUp) tensor form; with
        ``rows = (lo, hi)``, ``v`` and the result are those dw rows and
        ``full`` the whole V that the dw hops and non-local terms read."""
        dtype = torch.promote_types(v.dtype, self.dtype)
        v = v.to(dtype)
        full = v if full is None else full.to(dtype)
        r = slice(None) if rows is None else slice(*rows)
        d, hup_t, hdw, nl, ph = self._operands(dtype)
        out = d[..., r, :] * v
        out += v @ hup_t
        out += torch.matmul(hdw[r], full)
        nl.add_to(out, full, rows)
        if ph is not None:
            ph_mat, ph_x, eph_d, eph_up_t, eph_dw = ph
            out += torch.einsum("pq,...qdu->...pdu", ph_mat, v)
            ev = eph_d[..., r, :] * v + v @ eph_up_t \
                + torch.matmul(eph_dw[r], full)
            out += torch.einsum("pq,...qdu->...pdu", ph_x, ev)
        return out

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        lead = v.shape[:-1]
        ph, _, nu = self.shape3
        return self.apply3(v.reshape(*lead, ph, -1, nu)).reshape(*lead, -1)


class ShardedKronMatvec(KronMatvec):
    """:class:`KronMatvec` with the dw axis split over the ranks of
    ``mesh``; takes and returns this rank's rows of V[ph, dw, up] (a flat
    vector or a (B, local dim) block)."""

    def __init__(self, op: NormalSectorOp, device: torch.device,
                 dtype: torch.dtype, mesh: Mesh):
        super().__init__(op, device, dtype)
        self.mesh = mesh
        ph, nd, nu = self.shape3
        self.shard = RowShard(mesh, ph, nd, nu)
        self.local_dim = self.shard.local_dim

    def local(self, v: torch.Tensor) -> torch.Tensor:
        return self.shard.local(v)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(v)

    def apply3(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the matvec on the (..., DimPh, rows, DimUp)
        form, from the gathered V."""
        full = self.mesh.all_gather_rows(v, self.shape3[1], axis=-2)
        return super().apply3(v, (self.shard.lo, self.shard.hi), full)


class EllMatvec:
    """Padded-ELL sparse matvec along the last axis:
    out[..., i] = Σ_k vals[i, k] * v[..., cols[i, k]].

    Rows are padded to a fixed K with (col=i, val=0) entries; ``cols`` is
    int32. The rows are taken in chunks of ``CHUNK_ELEMS // (K * batch)``
    so that the gathered (batch, rows, K) temporary stays bounded.
    ``n_in``: the length of the input's last axis when the tables are a
    block of rows of a larger matrix (default: square)."""

    batched = True

    def __init__(self, cols: np.ndarray, vals: np.ndarray,
                 device: torch.device, dtype: torch.dtype = CDTYPE,
                 nnz: int = None, n_in: int = None):
        assert cols.shape == vals.shape and cols.ndim == 2
        self.dim, self.k = cols.shape
        self.n_in = self.dim if n_in is None else n_in
        self.dtype = dtype
        self.device = device
        self.cols = torch.as_tensor(np.asarray(cols, np.int32), device=device)
        self.vals = torch.as_tensor(np.asarray(vals), dtype=dtype,
                                    device=device)
        self.nnz = int(nnz if nnz is not None else np.count_nonzero(vals))
        self.n_calls = 0

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """out over the last axis of ``v`` (..., dim)."""
        lead = v.shape[:-1]
        v2 = v.reshape(-1, self.n_in)
        out = v2.new_empty(v2.shape[0], self.dim)
        step = max(1, CHUNK_ELEMS // (self.k * v2.shape[0]))
        for lo in range(0, self.dim, step):
            hi = min(self.dim, lo + step)
            g = v2.index_select(1, self.cols[lo:hi].reshape(-1))
            g = g.view(v2.shape[0], hi - lo, self.k).mul_(self.vals[lo:hi])
            torch.sum(g, -1, out=out[:, lo:hi])
        return out.reshape(*lead, self.dim)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        return self.apply(v)


def _eph_op(op: JointSectorOp) -> JointSectorOp:
    """The electron-phonon coupling's electronic matrix (eph_diag plus the
    eph COO terms) as a JointSectorOp of its own, for its ELL tables."""
    empty = np.zeros(0, np.int64)
    rows = op.eph_rows if op.eph_rows is not None else empty
    return JointSectorOp(
        sector=op.sector, dim_el=op.dim_el, rows=rows,
        cols=op.eph_cols if op.eph_rows is not None else empty,
        vals=op.eph_vals if op.eph_rows is not None else np.zeros(0, complex),
        diag=np.real(op.eph_diag))


class _JointBase:
    """What the joint matvecs share: the (..., DimPh, DimEl) view of the
    flat vector or block, and the phonon terms ph_mat ⊗ 1 + ph_x ⊗ E_eph."""

    batched = True

    def __init__(self, op: JointSectorOp, device: torch.device):
        self.dim_el = op.dim_el
        self.dim_ph = op.sector.dim_ph
        self.dim = self.dim_el * self.dim_ph
        self.dtype = CDTYPE
        self.device = device
        self.nnz = op.nnz_estimate()
        self.n_calls = 0
        self.has_ph = op.ph_mat is not None
        if self.has_ph:
            self.ph_mat = self._put(op.ph_mat)
            self.ph_x = self._put(op.ph_x)

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=CDTYPE,
                               device=self.device)

    def _put_idx(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def electronic(self, v2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eph(self, v2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def source(self, v2: torch.Tensor) -> torch.Tensor:
        """The whole electronic axis that the electronic terms read (``v2``
        itself; a row-split operator gathers it)."""
        return v2

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        lead = v.shape[:-1]
        v2 = v.reshape(*lead, self.dim_ph, -1).to(self.dtype)
        src = self.source(v2)
        out = self.electronic(src)
        if self.has_ph:
            out += self.ph_mat @ v2
            out += self.ph_x @ self.eph(src)
        return out.reshape(*lead, -1)


class JointMatvec(_JointBase):
    """superc/nonsu2 sector matvec: the padded-ELL electronic H (diagonal
    included) batched over the phonon axis, plus the phonon and
    electron-phonon Kronecker terms (the e-ph electronic matrix as ELL
    tables of its own). ``v`` is flat (DimPh * DimEl). ``rows = (lo,
    hi)``: only those electronic rows of the tables, read from the whole
    electronic axis."""

    def __init__(self, op: JointSectorOp, device: torch.device, rows=None):
        super().__init__(op, device)
        r = slice(None) if rows is None else slice(*rows)
        cols, vals = op.ell()
        self.ell = EllMatvec(cols[r], vals[r], device, n_in=self.dim_el)
        if self.has_ph:
            ecols, evals = _eph_op(op).ell()
            self.eph_ell = EllMatvec(ecols[r], evals[r], device,
                                     n_in=self.dim_el)

    @property
    def k(self) -> int:
        return self.ell.k

    def electronic(self, v2: torch.Tensor) -> torch.Tensor:
        return self.ell.apply(v2)

    def eph(self, v2: torch.Tensor) -> torch.Tensor:
        return self.eph_ell.apply(v2)


class JointMatvecDirect(_JointBase):
    """Memory-lean 'direct' joint matvec (the ``ed_sparse_H=F`` analog,
    reference ED_*/direct/ on-the-fly HxV): the raw COO term list applied
    by a scatter-add (``index_add_``), O(nnz) storage instead of the ELL's
    O(dim·K). On CUDA the scatter's atomics leave the order of each row's
    sum free, so its result differs from the ELL's in the last bits."""

    def __init__(self, op: JointSectorOp, device: torch.device):
        super().__init__(op, device)
        self.coo = (self._put_idx(op.rows), self._put_idx(op.cols),
                    self._put(op.vals))
        self.diag = self._put(op.diag)
        if self.has_ph:
            e = _eph_op(op)
            self.eph_coo = (self._put_idx(e.rows), self._put_idx(e.cols),
                            self._put(e.vals))
            self.eph_diag = self._put(e.diag)

    @staticmethod
    def _scatter(out, v2, coo) -> None:
        rows, cols, vals = coo
        step = max(1, CHUNK_ELEMS * v2.shape[-1] // v2.numel())
        for lo in range(0, rows.shape[0], step):
            hi = lo + step
            out.index_add_(-1, rows[lo:hi],
                           vals[lo:hi] * v2.index_select(-1, cols[lo:hi]))

    def electronic(self, v2: torch.Tensor) -> torch.Tensor:
        out = self.diag * v2
        self._scatter(out, v2, self.coo)
        return out

    def eph(self, v2: torch.Tensor) -> torch.Tensor:
        out = self.eph_diag * v2
        self._scatter(out, v2, self.eph_coo)
        return out


class ShardedJointMatvec(JointMatvec):
    """:class:`JointMatvec` with its electronic rows split over the ranks
    of ``mesh`` (the JAX package's ``shard_joint_matvec``): this rank keeps
    its block of rows of the ELL tables (and of the e-ph ELL), gathers v and
    contracts; ph_mat and ph_x act on the phonon axis and stay whole.
    Takes and returns this rank's rows of v[ph, el]."""

    def __init__(self, op: JointSectorOp, device: torch.device, mesh: Mesh):
        shard = RowShard(mesh, op.sector.dim_ph, op.dim_el, 1)
        super().__init__(op, device, rows=(shard.lo, shard.hi))
        self.mesh, self.shard = mesh, shard
        self.local_dim = shard.local_dim

    def local(self, v: torch.Tensor) -> torch.Tensor:
        return self.shard.local(v)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(v)

    def source(self, v2: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather_rows(v2, self.dim_el, axis=-1)
