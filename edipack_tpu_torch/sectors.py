"""Symmetry sectors of the impurity Fock space.

Parity targets: reference ED_SETUP.f90 (sector tables, :505-983) and
ED_SECTOR.f90 (build_sector basis maps, :165-373), re-expressed as plain
sorted integer arrays instead of linked maps.

Quantum numbers by mode (ED_INPUT_VARS.f90:247-252, ED_SETUP.f90:141-171):
  * normal : (Nup, Ndw) per system  (or per orbital when ed_total_ud=False)
  * superc : Sz = Nup - Ndw         (joint up⊗dw basis, pairing mixes N)
  * nonsu2 : Ntot = Nup + Ndw       (joint basis, spin-flip terms)

Joint states pack the two spin species as ``m = mup | (mdw << Ns)`` —
up levels at bits 0..Ns-1, down levels at bits Ns..2Ns-1, with the global
Jordan-Wigner string running over the joint bitset.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import EDConfig
from .fock import binom, enumerate_states, n_levels, popcount

# Orbital angular-momentum diagonal of the Jz-conserving 3-orbital (t2g,
# effective L=1) basis and spin Sz diagonal (reference ED_VARS_GLOBAL.f90:283-284)
LZDIAG = np.array([-1, +1, 0])
SZDIAG = np.array([+1, -1])


@dataclass(frozen=True)
class SpaceDims:
    """Global dimension bookkeeping (ED_SETUP.f90 ed_setup_dimensions)."""
    ns: int          # levels per spin species
    ns_orb: int      # levels per orbital block (== ns if ed_total_ud)
    ns_ud: int       # number of conserved (nup,ndw) factors (1 or norb)
    nlevels: int     # 2*ns
    dim_ph: int      # nph + 1
    nsectors: int


def space_dims(cfg: EDConfig) -> SpaceDims:
    ns = n_levels(cfg.bath_type, cfg.norb, cfg.nbath)
    if cfg.ed_total_ud:
        ns_orb, ns_ud = ns, 1
    else:
        ns_orb, ns_ud = ns // cfg.norb, cfg.norb
    dim_ph = cfg.nph + 1
    if cfg.ed_mode == "normal":
        nsectors = ((ns_orb + 1) ** 2) ** ns_ud
    elif cfg.ed_mode == "nonsu2" and cfg.jz_basis:
        w = jz_level_weights(cfg, ns)
        nsectors = sum(max_two_jz(w, n) + 1 for n in range(2 * ns + 1))
    else:  # superc: Sz in -Ns..Ns ; nonsu2: N in 0..2Ns
        nsectors = 2 * ns + 1
    return SpaceDims(ns, ns_orb, ns_ud, 2 * ns, dim_ph, nsectors)


def orbital_of_level(cfg: EDConfig, lvl: int) -> int:
    """Orbital character of one-spin level ``lvl`` under the bath layout
    (impurity levels first, then bath; reference getBathStride,
    ED_SETUP.f90:944-961)."""
    if lvl < cfg.norb:
        return lvl
    if cfg.bath_type in ("replica", "general"):
        return (lvl - cfg.norb) % cfg.norb
    if cfg.bath_type == "normal":
        return (lvl - cfg.norb) // cfg.nbath
    raise ValueError("hybrid bath levels carry no orbital character "
                     "(jz_basis requires replica/general/normal bath)")


def jz_level_weights(cfg: EDConfig, ns: int) -> np.ndarray:
    """Per joint-bit (level,spin) weight ``2*Lz(orb) + Sz(spin)`` so that
    2Jz(state) = occupations(state) @ weights (reference
    get_nonsu2_sector_dimension_Jz, ED_SETUP.f90:1036-1064)."""
    w = np.zeros(2 * ns, dtype=np.int64)
    for lvl in range(ns):
        lz = LZDIAG[orbital_of_level(cfg, lvl)]
        w[lvl] = 2 * lz + SZDIAG[0]
        w[lvl + ns] = 2 * lz + SZDIAG[1]
    return w


def max_two_jz(weights: np.ndarray, n: int) -> int:
    """Exact max of sum of ``n`` distinct per-level weights (greedy; agrees
    with the reference's Norb=3 closed formula at ED_SETUP.f90:817-827)."""
    if n == 0 or n == len(weights):
        return 0
    return int(np.sort(weights)[::-1][:n].sum())


@dataclass
class Sector:
    """One symmetry sector. For the normal mode the basis factorizes into
    separate up/down state lists and the vector is a matrix V[dim_dw, dim_up]
    (× phonon axis); for superc/nonsu2 a joint sorted state list is kept."""
    index: int
    mode: str
    qn: Tuple            # ('n', nup, ndw) | ('sz', sz) | ('nt', n)
    ns: int
    dim_ph: int = 1
    # normal mode factors (per ud-block lists; length ns_ud)
    up_states: Optional[List[np.ndarray]] = None
    dw_states: Optional[List[np.ndarray]] = None
    # joint basis (superc / nonsu2)
    states: Optional[np.ndarray] = None

    @cached_property
    def dim_up(self) -> int:
        return int(np.prod([len(s) for s in self.up_states])) if self.up_states else 0

    @cached_property
    def dim_dw(self) -> int:
        return int(np.prod([len(s) for s in self.dw_states])) if self.dw_states else 0

    @cached_property
    def dim_el(self) -> int:
        if self.states is not None:
            return len(self.states)
        return self.dim_up * self.dim_dw

    @property
    def dim(self) -> int:
        return self.dim_el * self.dim_ph

    # -- convenience for the (dominant) ns_ud == 1 case
    @property
    def ups(self) -> np.ndarray:
        return self.up_states[0]

    @property
    def dws(self) -> np.ndarray:
        return self.dw_states[0]

    @cached_property
    def nup(self) -> int:
        if self.mode == "normal":
            return sum(self.qn[1])
        raise AttributeError("nup undefined for joint sectors")

    @cached_property
    def ndw(self) -> int:
        if self.mode == "normal":
            return sum(self.qn[2])
        raise AttributeError("ndw undefined for joint sectors")

    def __repr__(self):
        return f"Sector({self.qn}, dim={self.dim})"


def _joint(mup: np.ndarray, mdw: np.ndarray, ns: int) -> np.ndarray:
    """All pairs (mup x mdw) packed as joint ints, any order."""
    return (mup[None, :] | (mdw[:, None] << np.int64(ns))).ravel()


class SectorTable:
    """All sectors for a given configuration, with lookup and ±particle
    connectivity (reference getSector/getCsector/getCDGsector tables,
    ED_SETUP.f90:525-983). Basis arrays are built lazily and cached."""

    def __init__(self, cfg: EDConfig):
        cfg.validate()
        self.cfg = cfg
        self.dims = space_dims(cfg)
        self._sector_cache: Dict[int, Sector] = {}
        self._qn_list: List[Tuple] = self._enumerate_qns()
        self._qn_to_index = {qn: i for i, qn in enumerate(self._qn_list)}

    # ------------------------------------------------------------------
    def _enumerate_qns(self) -> List[Tuple]:
        d = self.dims
        cfg = self.cfg
        if cfg.ed_mode == "normal":
            rng = range(d.ns_orb + 1)
            qns = []
            for nups in itertools.product(rng, repeat=d.ns_ud):
                for ndws in itertools.product(rng, repeat=d.ns_ud):
                    qns.append(("n", nups, ndws))
            return qns
        if cfg.ed_mode == "superc":
            return [("sz", sz) for sz in range(-d.ns, d.ns + 1)]
        if cfg.jz_basis:
            # (Ntot, 2Jz) sectors (reference setup_global_nonsu2 Jz branch,
            # ED_SETUP.f90:817-848): 2Jz runs -max..+max step 2 per N
            w = jz_level_weights(cfg, d.ns)
            qns = []
            for n in range(2 * d.ns + 1):
                mx = max_two_jz(w, n)
                for two_jz in range(-mx, mx + 1, 2):
                    qns.append(("ntj", n, two_jz))
            return qns
        return [("nt", n) for n in range(2 * d.ns + 1)]

    def __len__(self) -> int:
        return len(self._qn_list)

    def __iter__(self):
        return (self.sector(i) for i in range(len(self)))

    @property
    def qns(self) -> List[Tuple]:
        return list(self._qn_list)

    def index(self, qn: Tuple) -> int:
        return self._qn_to_index[qn]

    # ------------------------------------------------------------------
    def sector(self, i: int) -> Sector:
        if i not in self._sector_cache:
            self._sector_cache[i] = self._build(i)
        return self._sector_cache[i]

    def by_qn(self, qn: Tuple) -> Sector:
        return self.sector(self.index(qn))

    def _build(self, i: int) -> Sector:
        qn = self._qn_list[i]
        d = self.dims
        cfg = self.cfg
        if cfg.ed_mode == "normal":
            _, nups, ndws = qn
            if d.ns_ud == 1:
                ups = [enumerate_states(d.ns, nups[0])]
                dws = [enumerate_states(d.ns, ndws[0])]
            else:
                # ed_total_ud=False: per-orbital conserved counts. Build the
                # combined global bitset basis (sorted) from the product of
                # per-orbital registers mapped through the level layout
                # (reference Orbs/ include trees + breorder,
                # ED_AUX_FUNX.f90:411-437).
                ups = [self._orbital_product_basis(nups)]
                dws = [self._orbital_product_basis(ndws)]
            return Sector(i, "normal", qn, d.ns, d.dim_ph,
                          up_states=ups, dw_states=dws)
        if cfg.ed_mode == "superc":
            sz = qn[1]
            blocks = []
            for nup in range(max(0, sz), min(d.ns, d.ns + sz) + 1):
                ndw = nup - sz
                if ndw < 0 or ndw > d.ns:
                    continue
                blocks.append(_joint(enumerate_states(d.ns, nup),
                                     enumerate_states(d.ns, ndw), d.ns))
            states = np.sort(np.concatenate(blocks)) if blocks else np.empty(0, np.int64)
            return Sector(i, "superc", qn, d.ns, d.dim_ph, states=states)
        # nonsu2
        n = qn[1]
        states, two_jz = self._nonsu2_states(n)
        if qn[0] == "ntj":
            states = states[two_jz == qn[2]]
        return Sector(i, "nonsu2", qn, d.ns, d.dim_ph, states=states)

    def _nonsu2_states(self, n: int):
        """All joint states with Ntot=n (sorted) and, when jz_basis, their
        2Jz values; cached per n."""
        key = ("_ntstates", n)
        if key not in self._sector_cache:
            d = self.dims
            blocks = []
            for nup in range(max(0, n - d.ns), min(d.ns, n) + 1):
                ndw = n - nup
                blocks.append(_joint(enumerate_states(d.ns, nup),
                                     enumerate_states(d.ns, ndw), d.ns))
            states = (np.sort(np.concatenate(blocks)) if blocks
                      else np.empty(0, np.int64))
            two_jz = None
            if self.cfg.jz_basis:
                w = jz_level_weights(self.cfg, d.ns)
                two_jz = np.zeros(len(states), dtype=np.int64)
                for b in range(2 * d.ns):
                    two_jz += ((states >> np.int64(b)) & 1) * w[b]
            self._sector_cache[key] = (states, two_jz)
        return self._sector_cache[key]

    def _orbital_product_basis(self, counts) -> np.ndarray:
        """Global one-spin bitsets with orbital-a register holding counts[a]
        particles. Local register of orbital a: bit 0 = impurity level a,
        bits 1..Nbath = its bath levels (bath_level layout)."""
        from .fock import bath_level
        cfg = self.cfg
        d = self.dims
        out = np.zeros(1, dtype=np.int64)
        for a, n_a in enumerate(counts):
            local = enumerate_states(d.ns_orb, n_a)
            # map local bits to global positions
            glob = np.zeros(len(local), dtype=np.int64)
            for b in range(d.ns_orb):
                pos = a if b == 0 else bath_level(cfg.bath_type, cfg.norb,
                                                  cfg.nbath, a, b - 1)
                glob |= (((local >> np.int64(b)) & 1) << np.int64(pos))
            out = (out[:, None] | glob[None, :]).ravel()
        return np.sort(out)

    # ------------------------------------------------------------------
    def get_dim(self, i: int) -> int:
        """Sector dimension without materializing the basis
        (reference sector-dimension formulas, ED_SETUP.f90:998-1064)."""
        qn = self._qn_list[i]
        d = self.dims
        if qn[0] == "n":
            _, nups, ndws = qn
            du = int(np.prod([binom(d.ns_orb, n) for n in nups]))
            dd = int(np.prod([binom(d.ns_orb, n) for n in ndws]))
            return du * dd * d.dim_ph
        if qn[0] == "sz":
            sz = qn[1]
            tot = sum(binom(d.ns, nup) * binom(d.ns, nup - sz)
                      for nup in range(max(0, sz), d.ns + 1))
            return tot * d.dim_ph
        if qn[0] == "ntj":
            _, two_jz = self._nonsu2_states(qn[1])
            return int(np.count_nonzero(two_jz == qn[2])) * d.dim_ph
        n = qn[1]
        tot = sum(binom(d.ns, nup) * binom(d.ns, n - nup)
                  for nup in range(max(0, n - d.ns), min(d.ns, n) + 1))
        return tot * d.dim_ph

    # ------------------------------------------------------------------
    # ± particle connectivity (getCsector/getCDGsector; Jz variants
    # getCsector_Jz/getCDGsector_Jz, ED_SETUP.f90:944-983)
    def _two_jz_of_op(self, iorb: int, ispin: int) -> int:
        return 2 * int(LZDIAG[iorb]) + int(SZDIAG[ispin])

    def c_sector(self, i: int, ispin: int, iud: int = 0,
                 iorb: int = 0) -> Optional[int]:
        """Sector reached by removing one spin-``ispin`` particle (ispin:
        0=up,1=dw). ``iorb`` selects the orbital in the jz_basis, where the
        target sector depends on the removed operator's 2jz = 2Lz+Sz."""
        qn = self._qn_list[i]
        if qn[0] == "n":
            _, nups, ndws = qn
            nups, ndws = list(nups), list(ndws)
            tgt = nups if ispin == 0 else ndws
            tgt[iud] -= 1
            if tgt[iud] < 0:
                return None
            return self._qn_to_index.get(("n", tuple(nups), tuple(ndws)))
        if qn[0] == "sz":
            sz = qn[1] + (-1 if ispin == 0 else +1)
            return self._qn_to_index.get(("sz", sz))
        if qn[0] == "ntj":
            tgt = qn[2] - self._two_jz_of_op(iorb, ispin)
            return self._qn_to_index.get(("ntj", qn[1] - 1, tgt))
        return self._qn_to_index.get(("nt", qn[1] - 1))

    def cdg_sector(self, i: int, ispin: int, iud: int = 0,
                   iorb: int = 0) -> Optional[int]:
        qn = self._qn_list[i]
        if qn[0] == "n":
            _, nups, ndws = qn
            nups, ndws = list(nups), list(ndws)
            tgt = nups if ispin == 0 else ndws
            tgt[iud] += 1
            if tgt[iud] > self.dims.ns_orb:
                return None
            return self._qn_to_index.get(("n", tuple(nups), tuple(ndws)))
        if qn[0] == "sz":
            sz = qn[1] + (+1 if ispin == 0 else -1)
            return self._qn_to_index.get(("sz", sz))
        if qn[0] == "ntj":
            tgt = qn[2] + self._two_jz_of_op(iorb, ispin)
            return self._qn_to_index.get(("ntj", qn[1] + 1, tgt))
        return self._qn_to_index.get(("nt", qn[1] + 1))

    # ------------------------------------------------------------------
    def twin_of(self, i: int) -> int:
        """Twin sector index (Nup<->Ndw | Sz->-Sz | N->2Ns-N),
        reference ED_SECTOR.f90:1787-1843."""
        qn = self._qn_list[i]
        if qn[0] == "n":
            return self._qn_to_index[("n", qn[2], qn[1])]
        if qn[0] == "sz":
            return self._qn_to_index[("sz", -qn[1])]
        if qn[0] == "ntj":
            return self._qn_to_index.get(
                ("ntj", 2 * self.dims.ns - qn[1], -qn[2]), i)
        return self._qn_to_index[("nt", 2 * self.dims.ns - qn[1])]

    def twin_mask(self) -> np.ndarray:
        """True for sectors to be diagonalized when ed_twin is on
        (reference setup_global twin_mask, ED_SETUP.f90:592-603).

        normal and superc modes elide twins and reconstruct eigenvectors by
        a signed permutation (diag._twin_state_joint).  nonsu2 elides the
        Ntot > Ns half of the scan (the reference does the same); its
        particle-hole map has no basis-level signed permutation valid for
        arbitrary baths, so any elided sector whose states survive the trim
        is RE-SOLVED exactly (diag._resolve_nonsu2_twins) — at T=0 the
        ground sector is self-twin and the full 2x sweep saving realizes."""
        mask = np.ones(len(self), dtype=bool)
        if not self.cfg.ed_twin:
            return mask
        for i in range(len(self)):
            j = self.twin_of(i)
            if j != i and mask[j] and not self._is_canonical(i):
                mask[i] = False
        return mask

    def _is_canonical(self, i: int) -> bool:
        qn = self._qn_list[i]
        j = self.twin_of(i)
        return i <= j
