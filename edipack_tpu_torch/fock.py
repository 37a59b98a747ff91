"""Fock-space bit codec, vectorized.

Replaces the reference's scalar bit routines (ED_AUX_FUNX.f90:334-480:
`c`, `cdg`, `bdecomp`, `bjoin`, `binary_search`) with NumPy array ops over
whole sector bases at once. States are int64 bitsets; level ``p`` (0-based)
occupies bit ``p``. Fermionic sign convention matches the reference:
``c_p |m> = (-1)^{popcount(m & (2^p - 1))} |m xor 2^p>`` (JW string over
lower bits).

Level layout within one spin species (reference ED_SETUP.f90 setup_global_*
getBathStride):
  * impurity orbitals at levels ``0..Norb-1``
  * bath: normal    -> level ``Norb + iorb*Nbath + k``   (orb-major)
          hybrid    -> level ``Norb + k``
          replica / general -> level ``(k+1)*Norb + iorb`` (bath-major)
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# combinatorics
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def binom(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    k = min(k, n - k)
    out = 1
    for i in range(k):
        out = out * (n - i) // (i + 1)
    return out


def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for non-negative int64 arrays."""
    x = np.asarray(x, dtype=np.int64)
    return np.bitwise_count(x).astype(np.int64)


@lru_cache(maxsize=None)
def enumerate_states(ns: int, n: int) -> np.ndarray:
    """All ``ns``-bit integers with popcount ``n``, ascending (int64).

    The ascending order matches the reference sector maps built by upward
    popcount scan (ED_SECTOR.f90 build_sector:165-373). Enumerated by the
    native host library's Gosper enumeration (edipack_tpu_torch/native),
    or by NumPy under EDIPACK_TPU_TORCH_NO_NATIVE=1."""
    if n < 0 or n > ns:
        return np.empty(0, dtype=np.int64)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    from . import native
    if native.available():
        return native.enum_states(ns, n)
    if ns <= 20:
        allst = np.arange(1 << ns, dtype=np.int64)
        return allst[popcount(allst) == n]
    # recursive enumeration for wide registers (NumPy fallback):
    # states(ns, n) = states(ns-1, n) ++ (states(ns-1, n-1) | top_bit)
    lo = enumerate_states(ns - 1, n)
    hi = enumerate_states(ns - 1, n - 1) | (np.int64(1) << np.int64(ns - 1))
    return np.concatenate([lo, hi])


def state_index(basis: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Indices of ``states`` inside sorted ``basis`` (vectorized binary search,
    replacing ED_AUX_FUNX.f90:463-480). Out-of-basis states map to -1."""
    idx = np.searchsorted(basis, states)
    idx_c = np.clip(idx, 0, len(basis) - 1)
    ok = basis[idx_c] == states
    return np.where(ok, idx_c, -1)


# ---------------------------------------------------------------------------
# occupations and signs
# ---------------------------------------------------------------------------


def occupations(states: np.ndarray, ns: int) -> np.ndarray:
    """(len(states), ns) uint8 occupation-number table (bdecomp, vectorized)."""
    s = np.asarray(states, dtype=np.int64)[:, None]
    bits = np.arange(ns, dtype=np.int64)[None, :]
    return ((s >> bits) & 1).astype(np.uint8)


def parity_sign(states: np.ndarray, pos: int) -> np.ndarray:
    """JW sign (-1)^{#occupied levels below pos} as float64 array."""
    mask = (np.int64(1) << np.int64(pos)) - np.int64(1)
    return 1.0 - 2.0 * (popcount(np.asarray(states, np.int64) & mask) & 1).astype(np.float64)


def apply_c(states: np.ndarray, pos: int):
    """Vectorized annihilation at level ``pos``.

    Returns (new_states, signs, valid_mask); invalid rows keep the original
    state with sign 0."""
    states = np.asarray(states, dtype=np.int64)
    bit = np.int64(1) << np.int64(pos)
    valid = (states & bit) != 0
    sign = np.where(valid, parity_sign(states, pos), 0.0)
    new = np.where(valid, states ^ bit, states)
    return new, sign, valid


def apply_cdg(states: np.ndarray, pos: int):
    """Vectorized creation at level ``pos``."""
    states = np.asarray(states, dtype=np.int64)
    bit = np.int64(1) << np.int64(pos)
    valid = (states & bit) == 0
    sign = np.where(valid, parity_sign(states, pos), 0.0)
    new = np.where(valid, states | bit, states)
    return new, sign, valid


def hop_elements(basis: np.ndarray, ns: int, i: int, j: int):
    """Matrix elements of ``c^+_i c_j`` within a fixed-N basis.

    Returns (rows, cols, signs): H[rows[k], cols[k]] += signs[k].
    Handles i == j (density) as the diagonal occupation.
    Vectorized replacement for the reference's per-state Jcondition loops
    (e.g. ED_NORMAL/stored/H_up.f90)."""
    basis = np.asarray(basis, dtype=np.int64)
    if i == j:
        occ = (basis >> np.int64(i)) & 1
        rows = np.nonzero(occ)[0]
        return rows, rows, np.ones(len(rows), dtype=np.float64)
    k1, s1, v1 = apply_c(basis, j)
    k2, s2, v2 = apply_cdg(k1, i)
    valid = v1 & v2
    cols = np.nonzero(valid)[0]
    rows = state_index(basis, k2[cols])
    good = rows >= 0
    cols, rows = cols[good], rows[good]
    signs = (s1 * s2)[cols]
    return rows, cols, signs


# ---------------------------------------------------------------------------
# level layout (getBathStride parity, ED_SETUP.f90:648-667)
# ---------------------------------------------------------------------------


def bath_level(bath_type: str, norb: int, nbath: int, iorb: int, k: int) -> int:
    """0-based level index of bath site ``k`` (0-based) attached to orbital
    ``iorb`` (0-based)."""
    if bath_type == "normal":
        return norb + iorb * nbath + k
    if bath_type == "hybrid":
        return norb + k
    if bath_type in ("replica", "general"):
        return (k + 1) * norb + iorb
    raise ValueError(bath_type)


def n_levels(bath_type: str, norb: int, nbath: int) -> int:
    """Ns = number of levels per spin species (ED_SETUP.f90:118-126)."""
    if bath_type == "normal":
        return (nbath + 1) * norb
    if bath_type == "hybrid":
        return nbath + norb
    if bath_type in ("replica", "general"):
        return norb * (nbath + 1)
    raise ValueError(bath_type)
