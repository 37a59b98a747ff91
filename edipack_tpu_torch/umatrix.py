"""Two-body interaction specification.

Parity target: reference ED_PARSE_UMATRIX.f90 (set_umatrix :88-165,
add_twobody_operator :52-86, parse_umatrix_line :452+). The interaction is
held as
  * Kanamori arrays  — `uloc[Norb]`, `ust[N,N]` (opposite spins, distinct
    orbitals), `ustp[N,N] = Ust - Jh` (parallel spins), `jx[N,N]`
    (spin exchange), `jp[N,N]` (pair hopping)  — consumed by the
    density-diagonal and Kronecker-factor builders, and
  * a *sundry* list of generic terms ``U c^+_{i,si} c^+_{j,sj} c_{k,sk}
    c_{l,sl}`` applied verbatim, plus
  * a mean-field one-body matrix ``mf_hloc`` produced by anticommutators
    during normal ordering.

Operator/file convention (umatrix file lines): ``oi si oj sj ok sk ol sl U``
(1-based orbitals, spins 'u'/'d'), representing
``U * cd_{oi,si} cd_{oj,sj} c_{ok,sk} c_{ol,sl}``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .config import EDConfig

SPIN_UP, SPIN_DW = 0, 1
_SPIN_CHAR = {"u": SPIN_UP, "d": SPIN_DW}


@dataclass(frozen=True)
class TwoBodyTerm:
    """U * cd_{oi,si} cd_{oj,sj} c_{ok,sk} c_{ol,sl}; orbitals 0-based."""
    oi: int
    si: int
    oj: int
    sj: int
    ok: int
    sk: int
    ol: int
    sl: int
    u: complex

    def conserves_spin_counts(self) -> bool:
        return sorted((self.si, self.sj)) == sorted((self.sk, self.sl))

    def delta_nup(self) -> int:
        cr = (self.si == SPIN_UP) + (self.sj == SPIN_UP)
        an = (self.sk == SPIN_UP) + (self.sl == SPIN_UP)
        return cr - an


@dataclass(frozen=True)
class OpString:
    """A generic fermionic operator string ``coeff * ops[-1] ... ops[0]``:
    ``ops[0]`` is applied to the ket FIRST. Each op is (kind, orb, spin) with
    kind 'c' or 'cdg'. This is the *sundry* representation; matches the
    reference's right-to-left application order in H_sundry
    (ED_NORMAL/stored/H_sundry.f90)."""
    coeff: complex
    ops: Tuple[Tuple[str, int, int], ...]

    def delta_nup(self) -> int:
        return sum((+1 if k == "cdg" else -1) for k, _, s in self.ops if s == SPIN_UP)

    def delta_ndw(self) -> int:
        return sum((+1 if k == "cdg" else -1) for k, _, s in self.ops if s == SPIN_DW)


@dataclass
class Umatrix:
    """Internal interaction matrices (reference Uloc_internal etc.)."""
    norb: int
    uloc: np.ndarray = None        # (Norb,)
    ust: np.ndarray = None         # (Norb,Norb) opposite-spin coefficient
    ustp: np.ndarray = None        # (Norb,Norb) parallel-spin coefficient (Ust-Jh)
    jx: np.ndarray = None          # (Norb,Norb) spin exchange
    jp: np.ndarray = None          # (Norb,Norb) pair hopping
    mf_hloc: np.ndarray = None     # (2,2,Norb,Norb) mean-field one-body terms
    sundry: List[OpString] = field(default_factory=list)

    def __post_init__(self):
        n = self.norb
        if self.uloc is None:
            self.uloc = np.zeros(n)
        if self.ust is None:
            self.ust = np.zeros((n, n))
        if self.ustp is None:
            self.ustp = np.zeros((n, n))
        if self.jx is None:
            self.jx = np.zeros((n, n))
        if self.jp is None:
            self.jp = np.zeros((n, n))
        if self.mf_hloc is None:
            self.mf_hloc = np.zeros((2, 2, n, n))

    def has_nonlocal(self) -> bool:
        return bool(np.any(self.jx != 0) or np.any(self.jp != 0) or self.sundry)


# ---------------------------------------------------------------------------


def _classify(term: TwoBodyTerm, um: Umatrix) -> None:
    """Reference parse_umatrix_line algorithm (ED_PARSE_UMATRIX.f90:452-630).

    The incoming term means ``H += -0.5*U * cd_i cd_j c_k c_l`` (w2dynamics
    convention; verified against the reference Kanamori<->umatrix test
    equivalence). Steps: (0) u = -U/2; (1,2) sort the creation pair and the
    annihilation pair by (spin, orbital) with a sign per swap; (3) if
    cd_j == c_k the swap to [cd_i c_k][cd_j c_l] order produces a mean-field
    term u*cd_i c_l; (4) u -> -u for the swapped four-operator form;
    (5..7) classify [cd_i c_k][cd_j c_l] into Uloc/Ust/(Ust-Jh)/Jx/Jp;
    (8) otherwise keep as a generic op-string applied c_l,cd_j,c_k,cd_i."""
    if abs(term.u) < 1e-10:
        return
    u = -0.5 * term.u
    cd_i = (term.oi, term.si)
    cd_j = (term.oj, term.sj)
    c_k = (term.ok, term.sk)
    c_l = (term.ol, term.sl)
    # order creation ops by orbital then spin (spin overrides)
    if cd_i[0] > cd_j[0]:
        cd_i, cd_j, u = cd_j, cd_i, -u
    if cd_i[1] > cd_j[1]:
        cd_i, cd_j, u = cd_j, cd_i, -u
    # order annihilation ops by orbital then spin
    if c_k[0] > c_l[0]:
        c_k, c_l, u = c_l, c_k, -u
    if c_k[1] > c_l[1]:
        c_k, c_l, u = c_l, c_k, -u
    # mean-field term from {cd_j, c_k} anticommutator
    if cd_j == c_k:
        um.mf_hloc[cd_i[1], c_k[1], cd_i[0], c_k[0]] += np.real(u)
    # four-operator term in [cd_i c_k][cd_j c_l] order
    u = -u
    (oi, si), (oj, sj), (ok, sk), (ol, sl) = cd_i, cd_j, c_k, c_l
    ur = np.real(u)
    if oi == ok and oj == ol:
        if si != sj:
            if oi == oj:     # Uloc: n_{a,up} n_{a,dw}
                um.uloc[oi] += ur
                return
            um.ust[oi, oj] += ur          # Ust: opposite spins, a != b
            return
        if oi != oj:         # parallel spins, a != b: the (Ust-Jh) class
            um.ustp[oi, oj] += ur
            return
    # spin exchange: [cd_{a,up} c_{b,up}][cd_{b,dw} c_{a,dw}] pattern
    if oi != oj and si != sj and oi == ol and si == sk and oj == ok and sj == sl:
        um.jx[oi, ok] += ur
        return
    # pair hopping: [cd_{a,up} c_{b,up}][cd_{a,dw} c_{b,dw}] pattern
    if oi == oj and si != sj and oi != ok and si == sk and oj != ol and sj == sl:
        um.jp[oi, ok] += ur
        return
    um.sundry.append(OpString(
        coeff=u,
        ops=(("c", ol, sl), ("cdg", oj, sj), ("c", ok, sk), ("cdg", oi, si))))


def build_umatrix(cfg: EDConfig,
                  runtime_terms: Optional[List[TwoBodyTerm]] = None,
                  file_path: Optional[str] = None) -> Umatrix:
    """Assemble the internal interaction matrices (reference set_umatrix).

    Order of operations matches the reference: file/runtime terms are
    classified and symmetrized first, then Kanamori inputs are added on top
    (not subject to the symmetrization), ED_PARSE_UMATRIX.f90:115-143."""
    n = cfg.norb
    um = Umatrix(norb=n)
    terms: List[TwoBodyTerm] = []
    if cfg.ed_read_umatrix:
        if not cfg.ed_total_ud:
            raise ValueError("ed_total_ud=False and ed_read_umatrix=True are incompatible")
        path = file_path or (cfg.umatrix_file + ".restart")
        terms.extend(read_umatrix_file(path))
    if runtime_terms:
        terms.extend(runtime_terms)
    for t in terms:
        _classify(t, um)
    # symmetrize user-provided classes (reference :123-130)
    um.ust = (um.ust + um.ust.T) / 2.0
    um.ustp = (um.ustp + um.ustp.T) / 2.0
    if cfg.ed_use_kanamori:
        eye = np.eye(n)
        um.uloc += np.asarray(cfg.uloc_used)
        um.ust += cfg.ust * (1 - eye)
        um.ustp += (cfg.ust - cfg.jh) * (1 - eye)
        um.jx += cfg.jx * (1 - eye)
        um.jp += cfg.jp * (1 - eye)
    if not cfg.ed_total_ud and n > 1:
        if np.any(um.jx != 0) or np.any(um.jp != 0) or um.sundry:
            raise ValueError("ed_total_ud=False incompatible with non-density-density terms")
    return um


# ---------------------------------------------------------------------------
# file I/O (reference read_umatrix_file / save_umatrix_file)
# ---------------------------------------------------------------------------


def read_umatrix_file(path: str) -> List[TwoBodyTerm]:
    """Read ``oi si oj sj ok sk ol sl U`` lines; a leading header line with
    the number of operators is tolerated (reference format)."""
    terms = []
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as fh:
        for raw in fh:
            line = raw.split("!")[0].split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 9:
                continue  # header / count line
            oi, oj, ok, ol = (int(parts[0]), int(parts[2]),
                              int(parts[4]), int(parts[6]))
            si, sj, sk, sl = (parts[1].lower(), parts[3].lower(),
                              parts[5].lower(), parts[7].lower())
            u = float(parts[8].replace("d", "e").replace("D", "e"))
            terms.append(TwoBodyTerm(oi - 1, _SPIN_CHAR[si], oj - 1, _SPIN_CHAR[sj],
                                     ok - 1, _SPIN_CHAR[sk], ol - 1, _SPIN_CHAR[sl], u))
    return terms


def save_umatrix_file(um: Umatrix, path: str) -> None:
    """Write the active interaction as a umatrix file (reference
    save_umatrix_file)."""
    lines = []
    sc = {SPIN_UP: "u", SPIN_DW: "d"}
    n = um.norb
    # patterns mirror reference save_umatrix_file (:268-345) and are exact
    # inverses of the parse algorithm (verified by round-trip test)
    for a in range(n):
        if um.uloc[a] != 0:
            lines.append((a, "u", a, "d", a, "u", a, "d", um.uloc[a]))
            lines.append((a, "d", a, "u", a, "d", a, "u", um.uloc[a]))
    for a in range(n):
        for b in range(n):
            if a != b and um.ust[a, b] != 0:
                lines.append((a, "d", b, "u", a, "d", b, "u", um.ust[a, b]))
                lines.append((a, "u", b, "d", a, "u", b, "d", um.ust[a, b]))
            if a != b and um.ustp[a, b] != 0:
                lines.append((a, "u", b, "u", a, "u", b, "u", um.ustp[a, b]))
                lines.append((a, "d", b, "d", a, "d", b, "d", um.ustp[a, b]))
            if a != b and um.jx[a, b] != 0:
                lines.append((a, "d", b, "u", b, "d", a, "u", um.jx[a, b]))
                lines.append((a, "u", b, "d", b, "u", a, "d", um.jx[a, b]))
            if a != b and um.jp[a, b] != 0:
                lines.append((a, "d", a, "u", b, "d", b, "u", um.jp[a, b]))
                lines.append((a, "u", a, "d", b, "u", b, "d", um.jp[a, b]))
    for t in um.sundry:
        # stored as u * cd_i c_k cd_j c_l with ops=(c_l, cd_j, c_k, cd_i);
        # the equivalent file line is U_file = 2*u on cd_i cd_j c_k c_l
        (ol, sl_), (oj, sj_), (ok, sk_), (oi, si_) = (
            t.ops[0][1:], t.ops[1][1:], t.ops[2][1:], t.ops[3][1:])
        lines.append((oi, sc[si_], oj, sc[sj_], ok, sc[sk_],
                      ol, sc[sl_], 2.0 * t.coeff))
    with open(path, "w") as fh:
        fh.write(f"{len(lines)}\n")
        for (oi, si, oj, sj, ok, sk, ol, sl, u) in lines:
            fh.write(f"{oi+1} {si} {oj+1} {sj} {ok+1} {sk} {ol+1} {sl} "
                     f"{float(np.real(u)):.12f}\n")


def _spin_idx(s) -> int:
    """'u'/'d' chars or 1-based ints (the reference C binding passes ints,
    edipack_cbindings.h add_twobody_operator)."""
    if isinstance(s, str):
        return _SPIN_CHAR[s.lower()]
    return SPIN_UP if int(s) == 1 else SPIN_DW


def make_term(oi, si, oj, sj, ok, sk, ol, sl, u) -> TwoBodyTerm:
    """User-facing constructor with 1-based orbitals and 'u'/'d' (or 1/2)
    spins (reference add_twobody_operator signature)."""
    return TwoBodyTerm(oi - 1, _spin_idx(si), oj - 1, _spin_idx(sj),
                       ok - 1, _spin_idx(sk), ol - 1, _spin_idx(sl), u)
