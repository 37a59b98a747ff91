"""The yardstick of kernel roofline shares: the card's peaks and the least
work a normal-sector matvec must do, counted from the model and the
sector's shape alone, never from a kernel's own tables.

A matvec H·v of a (Nup, Ndw) sector of n = du·dd states must read v once
and write H·v once, and read each spin's hopping factor table once at one
value and one index (int32) a nonzero; it performs two operations per
nonzero of H (the diagonal, both hopping factors spread over the other
spin's states, and the Jx/Jp products). The arithmetic is a frozen copy of
``chip_smoke.py``'s ``bound`` (commit a90ee7e), restricted to these terms.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from edbench.reference import fermions as fm

# H100 SXM, NVIDIA data sheet, at its 700 W limit: FP64 (tensor core)
# 67 TFLOP/s, HBM3 3.35 TB/s
PEAK_FLOPS_F64 = 67e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> float:
    """The least seconds of the work: operations or bytes at the peak."""
    return max(flops / PEAK_FLOPS_F64, nbytes / PEAK_BYTES)


@lru_cache(maxsize=None)
def normal_sector_work(norb: int, nbath: int, nup: int, ndw: int,
                       jx: bool, jp: bool, elem_bytes: int = 8
                       ) -> Tuple[float, float]:
    """(operations, bytes) of one matvec of sector (nup, ndw) of a normal
    bath; ``jx`` / ``jp``: whether the spin-exchange and pair-hopping
    terms are present."""
    ns = norb * (nbath + 1)
    ub, db = fm.basis(ns, nup), fm.basis(ns, ndw)
    du, dd = len(ub), len(db)
    hops = [(norb + a * nbath + k, a) for a in range(norb)
            for k in range(nbath)]
    hops += [(j, i) for i, j in hops]

    def nnz(b, i, j):
        """Nonzeros of c†_i c_j on basis b."""
        return int(np.count_nonzero(
            fm.string_map(b, b, [("c", j), ("cdg", i)]).sgn))

    nnz_u = sum(nnz(ub, i, j) for i, j in hops)
    nnz_d = sum(nnz(db, i, j) for i, j in hops)
    nnz_x = 0
    for a in range(norb):
        for b in range(norb):
            if a == b:
                continue
            if jx:      # [c†_a c_b]_up [c†_b c_a]_dw
                nnz_x += nnz(ub, a, b) * nnz(db, b, a)
            if jp:      # [c†_a c_b]_up [c†_a c_b]_dw
                nnz_x += nnz(ub, a, b) * nnz(db, a, b)
    n = du * dd
    flops = 2.0 * (n + nnz_u * dd + nnz_d * du + nnz_x)
    nbytes = 2.0 * elem_bytes * n + (elem_bytes + 4) * (nnz_u + nnz_d)
    return flops, nbytes
