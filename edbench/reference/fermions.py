"""Fock-space bookkeeping of the plain reference: spin registers, their
bases, and fermion operators on them as signed pull maps.

A joint state is (u, d): the up register's bits are levels 0..ns-1 and the
down register's are ns..2ns-1, so the Jordan-Wigner string of a down
operator runs over every up level. An operator that acts on one register
is a map from a source basis to a target basis; a product of creation and
annihilation operators sends each source state to at most one target, so
it is stored in pull form: target row r takes source row ``src[r]`` with
sign ``sgn[r]`` (0 where no source reaches it).

Nothing here imports the program under test.
"""
from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple

import numpy as np


def basis(ns: int, n: Optional[int] = None) -> np.ndarray:
    """Ascending register states with ``n`` particles (all 2^ns if None;
    none when ``n`` is outside 0..ns)."""
    if n is None:
        return np.arange(1 << ns, dtype=np.int64)
    if not 0 <= n <= ns:
        return np.zeros(0, dtype=np.int64)
    out = [sum(1 << i for i in c) for c in combinations(range(ns), n)]
    return np.array(sorted(out), dtype=np.int64)


def popcount(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    return np.array([bin(int(v)).count("1") for v in x.ravel()],
                    dtype=np.int64).reshape(x.shape)


def occupations(states: np.ndarray, ns: int) -> np.ndarray:
    """(len(states), ns) 0/1 occupations."""
    s = np.asarray(states, dtype=np.int64)[:, None]
    return ((s >> np.arange(ns, dtype=np.int64)[None, :]) & 1).astype(float)


def _apply(states: np.ndarray, kind: str, pos: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """c (kind "c") or c† ("cdg") at register level ``pos``: new states and
    signs (0 where the operator kills the state); the sign counts the
    occupied levels below ``pos`` in this register."""
    bit = np.int64(1) << np.int64(pos)
    occ = (states & bit) != 0
    ok = occ if kind == "c" else ~occ
    below = popcount(states & (bit - 1))
    sign = np.where(ok, 1.0 - 2.0 * (below & 1), 0.0)
    return np.where(ok, states ^ bit, states), sign


class Map:
    """A register operator in pull form between two bases."""

    def __init__(self, src: np.ndarray, sgn: np.ndarray):
        self.src = np.asarray(src, dtype=np.int64)
        self.sgn = np.asarray(sgn, dtype=float)


def string_map(src_basis: np.ndarray, tgt_basis: np.ndarray,
               ops: Sequence[Tuple[str, int]], parity_first: bool = False
               ) -> Map:
    """Pull map of ``ops`` (applied in list order, each (kind, level)) from
    ``src_basis`` into ``tgt_basis``. ``parity_first``: multiply by
    (-1)^N of the source state first (the up-register string that a down
    operator carries)."""
    st = np.asarray(src_basis, dtype=np.int64).copy()
    sign = np.ones(len(st))
    if parity_first:
        sign = sign * (1.0 - 2.0 * (popcount(st) & 1))
    for kind, lvl in ops:
        st, s = _apply(st, kind, lvl)
        sign = sign * s
    alive = sign != 0
    pos = np.searchsorted(tgt_basis, st[alive])
    inside = pos < len(tgt_basis)
    pos_ok = np.zeros(alive.sum(), dtype=bool)
    pos_ok[inside] = tgt_basis[pos[inside]] == st[alive][inside]
    src_idx = np.nonzero(alive)[0][pos_ok]
    tgt_idx = pos[pos_ok]
    src = np.zeros(len(tgt_basis), dtype=np.int64)
    sgn = np.zeros(len(tgt_basis))
    src[tgt_idx] = src_idx
    sgn[tgt_idx] = sign[alive][pos_ok]
    return Map(src, sgn)


def one_body_matrix(b: np.ndarray, terms: List[Tuple[int, int, float]]
                    ) -> np.ndarray:
    """Dense sum of t c†_i c_j (i != j) over one register basis."""
    h = np.zeros((len(b), len(b)))
    for i, j, t in terms:
        if t == 0.0:
            continue
        m = string_map(b, b, [("c", j), ("cdg", i)])
        rows = np.nonzero(m.sgn)[0]
        h[rows, m.src[rows]] += t * m.sgn[rows]
    return h


def joint_string(up_src: np.ndarray, up_tgt_of, dw_src: np.ndarray,
                 dw_tgt_of, ops: Sequence[Tuple[str, int, int]]
                 ) -> Tuple[List[Map], List[Map]]:
    """Split a joint operator string (each (kind, level, spin), applied in
    list order, spin 0 up / 1 down) into up and down factors:
    a down operator is (-1)^{N_up} on the up register times the down
    operator. Returns the per-register factor lists, each a Map between
    consecutive bases; ``*_tgt_of(n)`` gives a register's basis of n
    particles (or the full register when the bases are not fixed-N)."""
    ups, dws = [], []
    nu = None if up_tgt_of is None else int(popcount(up_src[:1])[0])
    nd = None if dw_tgt_of is None else int(popcount(dw_src[:1])[0])
    cur_u, cur_d = up_src, dw_src
    for kind, lvl, spin in ops:
        step = 1 if kind == "cdg" else -1
        if spin == 0:
            nu = None if nu is None else nu + step
            nxt = cur_u if up_tgt_of is None else up_tgt_of(nu)
            ups.append(string_map(cur_u, nxt, [(kind, lvl)]))
            cur_u = nxt
        else:
            ups.append(string_map(cur_u, cur_u, [], parity_first=True))
            nd = None if nd is None else nd + step
            nxt = cur_d if dw_tgt_of is None else dw_tgt_of(nd)
            dws.append(string_map(cur_d, nxt, [(kind, lvl)]))
            cur_d = nxt
    return ups, dws


def compose(maps: List[Map], n_src: int) -> Map:
    """One pull map for maps applied in list order (first acts first)."""
    if not maps:
        return Map(np.arange(n_src), np.ones(n_src))
    src, sgn = maps[0].src, maps[0].sgn
    for m in maps[1:]:
        if len(src):
            src, sgn = src[m.src], sgn[m.src] * m.sgn
        else:       # an empty register in between: the string is zero
            src, sgn = np.zeros(len(m.src), np.int64), np.zeros(len(m.src))
    return Map(src, sgn)
