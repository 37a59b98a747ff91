"""Host-side metadata for the fused (single-kernel) normal-mode matvec.

TPU-first redesign of the reference's hottest loop — the per-sector
``H·v`` consumed by Lanczos (ED_NORMAL/ED_HAMILTONIAN_NORMAL_STORED_HxV.f90:
765-1082).  Two structural facts make a much faster kernel possible than
either a CSR SpMV (the reference) or dense Kronecker matmuls (our baseline
path):

1. **imp-MSB basis ordering.**  Re-ranking each spin basis by the key
   ``(impurity bits << (Ns-Norb)) | bath bits`` groups states by impurity
   configuration.  Under this ordering every Kanamori non-local factor
   (spin-exchange Jx, pair-hopping Jp — reference stored/H_non_local.f90)
   becomes a *single contiguous constant-offset run*: the operator
   ``c†_a c_b`` only permutes the impurity MSBs while acting as the identity
   on the rank-ordered bath states, and the Jordan-Wigner string over the
   in-between impurity bits is constant per (a,b).  The 8 full-array gather
   ops of the permutation form collapse to slice-shifted adds.

2. **Sparse factors.**  The one-spin hop matrices carry ~6 nnz/row.  The
   TPU kernels multiply their nonzero 128x128 blocks as dense MXU tiles;
   the CUDA kernels (csrc/row_gather.cu) read ELL tables of the same
   permuted factors (``ell_table``), the ~6 nonzeros of each row, and skip
   the zeros that the blocks still hold.

The device side lives in ops.fused_matvec; this module holds the pure NumPy
metadata builder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

BLK = 128          # column block of the fused kernels' layout
DIAG_RANK = 8      # padded low-rank width of the diagonal


def msb_perm(states: np.ndarray, norb: int) -> np.ndarray:
    """Permutation sorting one-spin basis states by the imp-MSB key
    (impurity bits most significant, bath rank within)."""
    s = np.asarray(states, dtype=np.int64).reshape(-1)
    mask = (1 << norb) - 1
    key = ((s & mask) << 48) | (s >> norb)
    return np.argsort(key, kind="stable").astype(np.int32)


def _runs_of_perm(src: np.ndarray, sgn: np.ndarray
                  ) -> List[Tuple[int, int, int, float]]:
    """Maximal (row0, col0, length, value) constant-offset contiguous runs of
    the partial permutation  M[r, src[r]] = sgn[r]  (sgn 0 marks empty)."""
    rows = np.nonzero(sgn)[0]
    if len(rows) == 0:
        return []
    cols = src[rows]
    vals = sgn[rows]
    runs = []
    i = 0
    while i < len(rows):
        j = i + 1
        while (j < len(rows) and rows[j] == rows[j - 1] + 1
               and cols[j] == cols[j - 1] + 1 and vals[j] == vals[i]):
            j += 1
        runs.append((int(rows[i]), int(cols[i]), int(j - i), float(vals[i])))
        i = j
    return runs


def _permute_perm(src: np.ndarray, sgn: np.ndarray, perm: np.ndarray,
                  ipos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Re-index a partial permutation (src, sgn) into the ordering ``perm``
    (internal i <-> original perm[i]); ipos is the inverse of perm."""
    src2 = ipos[src[perm]].astype(np.int64)
    sgn2 = sgn[perm]
    return src2, sgn2


def ell_table(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ELL form of the square matrix ``h``: (idx, val), both (width, n),
    slot-major, so that  (h @ x)[i] = sum_e val[e, i] * x[idx[e, i]].

    ``width`` is the largest number of nonzeros in a row (at least 1). A
    row's nonzeros fill its first slots in column order; its empty slots
    hold value 0 and the row's own index, so every index is in range.
    Returns (idx int32, val f64)."""
    n = h.shape[0]
    rows, cols = np.nonzero(h)
    counts = np.bincount(rows, minlength=n)
    width = max(int(counts.max(initial=0)), 1)
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    idx = np.tile(np.arange(n, dtype=np.int32), (width, 1))
    val = np.zeros((width, n), np.float64)
    idx[slot, rows] = cols
    val[slot, rows] = h[rows, cols]
    return idx, val


@dataclass
class NlRun:
    """One non-local Kronecker term B (x) A as a rectangle-shifted add:
    out[dd0:dd0+ld, du0:du0+lu] += val * v[sd0:sd0+ld, su0:su0+lu]."""
    val: float
    dd0: int
    sd0: int
    ld: int
    du0: int
    su0: int
    lu: int


@dataclass
class FusedNormalOp:
    """Imp-MSB-ordered operator data for the fused kernels.

    The kernel works on padded (ddp, dup) tensors; entries beyond (dd, du)
    are structurally zero.  perm_up/perm_dw map internal index -> original
    basis position (v_int[i] = v_orig[perm[i]])."""
    dd: int
    du: int
    ddp: int
    dup: int
    perm_up: np.ndarray
    perm_dw: np.ndarray
    # diagonal low-rank factors: D = diag_a @ diag_b.T  (ddp,R) (dup,R), f64
    diag_a: np.ndarray
    diag_b: np.ndarray
    nl_runs: List[NlRun]
    nnz: int
    # ELL tables (``ell_table``) of the permuted padded factors Hup (rows u)
    # and Hdw (rows d), f64 values
    up_ell_idx: np.ndarray
    up_ell_val: np.ndarray
    dw_ell_idx: np.ndarray
    dw_ell_val: np.ndarray

    # ---- layouts -------------------------------------------------------
    def to_blocked(self, v2: np.ndarray) -> np.ndarray:
        """(ddp, dup) 2D layout -> column-blocked kernel layout
        (nbu*ddp, BLK): V3[(j*ddp + d), r] = V[d, j*BLK + r]."""
        nbu = self.dup // BLK
        return np.ascontiguousarray(
            v2.reshape(self.ddp, nbu, BLK).swapaxes(0, 1)
            .reshape(nbu * self.ddp, BLK))

    def from_blocked(self, v3: np.ndarray) -> np.ndarray:
        nbu = self.dup // BLK
        return np.ascontiguousarray(
            v3.reshape(nbu, self.ddp, BLK).swapaxes(0, 1)
            .reshape(self.ddp, self.dup))

    @property
    def n_internal(self) -> int:
        return (self.dup // BLK) * self.ddp * BLK

    def to_internal(self, v: np.ndarray) -> np.ndarray:
        """(dd, du) original-layout -> padded internal layout."""
        out = np.zeros((self.ddp, self.dup), v.dtype)
        out[:self.dd, :self.du] = v[np.ix_(self.perm_dw, self.perm_up)]
        return out

    def from_internal(self, v: np.ndarray) -> np.ndarray:
        out = np.empty((self.dd, self.du), v.dtype)
        out[np.ix_(self.perm_dw, self.perm_up)] = v[:self.dd, :self.du]
        return out


def _pad(n: int, blk: int = BLK) -> int:
    return -(-n // blk) * blk


def build_fused_normal(op, norb: int) -> Optional[FusedNormalOp]:
    """Build fused-kernel metadata from a models.normal.NormalSectorOp.

    Returns None when the operator shape is outside the fused kernel's
    domain (phonons present, non-local terms that do not reduce to single
    contiguous runs, or missing low-rank diagonal factors)."""
    if op.ph_mat is not None:
        return None
    dfac = getattr(op, "d_factors", None)
    if dfac is None:
        return None
    sec = op.sector
    perm_up = msb_perm(np.asarray(sec.ups), norb)
    perm_dw = msb_perm(np.asarray(sec.dws), norb)
    ipos_up = np.empty_like(perm_up)
    ipos_up[perm_up] = np.arange(len(perm_up), dtype=np.int32)
    ipos_dw = np.empty_like(perm_dw)
    ipos_dw[perm_dw] = np.arange(len(perm_dw), dtype=np.int32)

    dd, du = op.hdw.shape[0], op.hup.shape[0]
    ddp, dup = _pad(dd), _pad(du)

    # non-local terms -> single-run rectangles (else bail)
    nl_runs: List[NlRun] = []
    if op.nl_perm is not None:
        src_a, sgn_a, src_b, sgn_b = op.nl_perm
        for k in range(src_a.shape[0]):
            sa, ga = _permute_perm(src_a[k], sgn_a[k], perm_up, ipos_up)
            sb, gb = _permute_perm(src_b[k], sgn_b[k], perm_dw, ipos_dw)
            ra = _runs_of_perm(sa, ga)
            rb = _runs_of_perm(sb, gb)
            if len(ra) != 1 or len(rb) != 1:
                return None
            (u0, su0, lu, va) = ra[0]
            (d0, sd0, ld, vb) = rb[0]
            nl_runs.append(NlRun(val=va * vb, dd0=d0, sd0=sd0, ld=ld,
                                 du0=u0, su0=su0, lu=lu))

    hup = np.zeros((dup, dup))
    hup[:du, :du] = op.hup[np.ix_(perm_up, perm_up)]
    hdw = np.zeros((ddp, ddp))
    hdw[:dd, :dd] = op.hdw[np.ix_(perm_dw, perm_dw)]

    up_idx, up_val = ell_table(hup)
    dw_idx, dw_val = ell_table(hdw)

    ddw, dup_vec, adw, bup = dfac
    r = adw.shape[1]
    if 2 + r > DIAG_RANK:
        return None
    a64 = np.zeros((ddp, DIAG_RANK), np.float64)
    b64 = np.zeros((dup, DIAG_RANK), np.float64)
    a64[:dd, 0] = ddw[perm_dw]
    b64[:du, 0] = 1.0
    a64[:dd, 1] = 1.0
    b64[:du, 1] = dup_vec[perm_up]
    a64[:dd, 2:2 + r] = adw[perm_dw]
    b64[:du, 2:2 + r] = bup[perm_up]

    return FusedNormalOp(
        dd=dd, du=du, ddp=ddp, dup=dup,
        perm_up=perm_up, perm_dw=perm_dw, diag_a=a64, diag_b=b64,
        nl_runs=nl_runs, nnz=op.nnz_estimate(),
        up_ell_idx=up_idx, up_ell_val=up_val,
        dw_ell_idx=dw_idx, dw_ell_val=dw_val,
    )
