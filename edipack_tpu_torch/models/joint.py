"""Joint-basis sector Hamiltonians for superc (Sz sectors) and nonsu2
(N sectors); counterpart of edipack_tpu.models.joint (host NumPy, kept as
this package's own copy).

Parity targets: reference ED_SUPERC/stored/{Himp,Hbath,Hint,Himp_bath}.f90 and
ED_NONSU2/stored/* — the per-state scalar loops become vectorized operator
applications over the whole joint state array. States pack both spins as
``m = mup | (mdw << Ns)`` with the full Jordan-Wigner string over the joint
bitset (reference applies c/cdg at positions iorb and iorb+Ns on the joint
integer).

Output is COO (rows, cols, vals) + dense diagonal; ops.matvec.EllMatvec /
JointMatvec / JointMatvecDirect consume it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..bath.dmft_bath import DmftBath, bath_levels, bath_hyb
from ..config import EDConfig
from ..fock import apply_c, apply_cdg, bath_level, occupations, state_index
from ..sectors import Sector
from ..umatrix import SPIN_UP, SPIN_DW, Umatrix
from .normal import _phonon_matrices, g_ph_matrix


@dataclass
class JointSectorOp:
    sector: Sector
    dim_el: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray          # complex128
    diag: np.ndarray          # (dim_el,) real part of the diagonal
    # phonons
    ph_mat: Optional[np.ndarray] = None
    ph_x: Optional[np.ndarray] = None
    eph_diag: Optional[np.ndarray] = None       # (dim_el,)
    eph_rows: Optional[np.ndarray] = None
    eph_cols: Optional[np.ndarray] = None
    eph_vals: Optional[np.ndarray] = None

    def nnz_estimate(self) -> int:
        nnz = len(self.rows) + self.dim_el
        if self.eph_rows is not None:
            nnz += (len(self.eph_rows) + self.dim_el) * 2
        return int(nnz * max(1, self.sector.dim_ph))

    def el_matrix(self) -> np.ndarray:
        h = np.zeros((self.dim_el, self.dim_el), dtype=complex)
        np.add.at(h, (self.rows, self.cols), self.vals)
        h += np.diag(self.diag.astype(complex))
        return h

    def to_dense(self) -> np.ndarray:
        h = self.el_matrix()
        dp = self.sector.dim_ph
        if dp == 1:
            return h
        full = np.kron(np.eye(dp), h) + np.kron(self.ph_mat,
                                                np.eye(self.dim_el))
        e_el = np.zeros((self.dim_el, self.dim_el), dtype=complex)
        if self.eph_rows is not None:
            np.add.at(e_el, (self.eph_rows, self.eph_cols), self.eph_vals)
        e_el += np.diag(self.eph_diag.astype(complex))
        full += np.kron(self.ph_x, e_el)
        return full

    def ell(self, pad_to: Optional[int] = None):
        """(cols, vals) padded-ELL of the full electronic H incl. diagonal."""
        dim = self.dim_el
        rows = np.concatenate([self.rows, np.arange(dim)])
        cols = np.concatenate([self.cols, np.arange(dim)])
        vals = np.concatenate([self.vals, self.diag.astype(complex)])
        # accumulate duplicates
        lin = rows.astype(np.int64) * dim + cols
        order = np.argsort(lin, kind="stable")
        lin, rows, cols, vals = lin[order], rows[order], cols[order], vals[order]
        uniq, inv = np.unique(lin, return_inverse=True)
        acc = np.zeros(len(uniq), dtype=complex)
        np.add.at(acc, inv, vals)
        rows_u = (uniq // dim).astype(np.int64)
        cols_u = (uniq % dim).astype(np.int64)
        counts = np.bincount(rows_u, minlength=dim)
        k = int(counts.max()) if len(counts) else 1
        if pad_to:
            k = max(k, pad_to)
        ecols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
        evals = np.zeros((dim, k), dtype=complex)
        slot = np.zeros(dim, dtype=np.int64)
        # vectorized slot assignment: position within each row
        pos_in_row = np.arange(len(rows_u)) - np.concatenate(
            [[0], np.cumsum(counts)])[rows_u]
        ecols[rows_u, pos_in_row] = cols_u
        evals[rows_u, pos_in_row] = acc
        return ecols, evals


class JointTermAccumulator:
    """Vectorized term builder over one joint sector basis."""

    def __init__(self, states: np.ndarray, ns: int):
        self.states = np.asarray(states, np.int64)
        self.ns = ns
        self.dim = len(states)
        self.occ = occupations(states, 2 * ns).astype(np.float64)
        self.diag = np.zeros(self.dim)
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []

    def pos(self, level: int, spin: int) -> int:
        return level + spin * self.ns

    def add_diag(self, d: np.ndarray) -> None:
        self.diag += np.real(d)

    def add_opstring(self, ops: List[Tuple[str, int, int]], coeff: complex,
                     out: Optional["JointTermAccumulator"] = None) -> None:
        """H[target, source] += coeff * <target| ops_applied |source>.

        ops: [(kind, level, spin)] applied to the ket in list order;
        full joint JW signs."""
        if coeff == 0:
            return
        st = self.states
        sign = np.ones(self.dim)
        valid = np.ones(self.dim, dtype=bool)
        for kind, lvl, spin in ops:
            fn = apply_c if kind == "c" else apply_cdg
            st, s, v = fn(st, self.pos(lvl, spin))
            sign = sign * s
            valid &= v
        tgt_states = state_index((out or self).states, st[valid])
        src = np.nonzero(valid)[0]
        good = tgt_states >= 0
        rows = tgt_states[good]
        cols = src[good]
        vals = coeff * sign[valid][good]
        acc = out or self
        acc._rows.append(rows)
        acc._cols.append(cols)
        acc._vals.append(np.asarray(vals, complex))

    def coo(self):
        if self._rows:
            rows = np.concatenate(self._rows)
            cols = np.concatenate(self._cols)
            vals = np.concatenate(self._vals).astype(complex)
        else:
            rows = np.zeros(0, np.int64)
            cols = np.zeros(0, np.int64)
            vals = np.zeros(0, complex)
        keep = vals != 0
        return rows[keep], cols[keep], vals[keep]


# ---------------------------------------------------------------------------


def _interaction_diag(acc: JointTermAccumulator, cfg: EDConfig, um: Umatrix,
                      norb: int) -> None:
    """Kanamori density-density + Hartree on the joint occupations
    (identical content to the normal-mode H_local/Hint)."""
    o_up = acc.occ[:, :norb]
    o_dw = acc.occ[:, acc.ns: acc.ns + norb]
    ust_nd = um.ust - np.diag(np.diag(um.ust))
    ustp_nd = um.ustp - np.diag(np.diag(um.ustp))
    d = (o_up * o_dw) @ um.uloc
    d += 0.5 * np.einsum("ia,ab,ib->i", o_up, ust_nd, o_dw) \
        + 0.5 * np.einsum("ia,ab,ib->i", o_dw, ust_nd, o_up)
    d += 0.5 * np.einsum("ia,ab,ib->i", o_up, ustp_nd, o_up) \
        + 0.5 * np.einsum("ia,ab,ib->i", o_dw, ustp_nd, o_dw)
    if cfg.hfmode:
        ntot = o_up + o_dw
        shift = -0.5 * um.uloc - 0.5 * (ust_nd.sum(1) + ustp_nd.sum(1))
        d += ntot @ shift
        d += 0.25 * um.uloc.sum() + 0.25 * (ust_nd.sum() + ustp_nd.sum())
    acc.add_diag(d)


def _jxjp_terms(acc: JointTermAccumulator, um: Umatrix, norb: int) -> None:
    """Spin exchange and pair hopping in the joint basis (reference
    ED_SUPERC/stored/Hint.f90:60-120: operator c_j↑,c_i↓,c†_j↓,c†_i↑ order)."""
    for a in range(norb):
        for b in range(norb):
            if a != b and um.jx[a, b] != 0:
                acc.add_opstring([("c", b, SPIN_UP), ("c", a, SPIN_DW),
                                  ("cdg", b, SPIN_DW), ("cdg", a, SPIN_UP)],
                                 um.jx[a, b])
            if a != b and um.jp[a, b] != 0:
                acc.add_opstring([("c", b, SPIN_UP), ("c", b, SPIN_DW),
                                  ("cdg", a, SPIN_DW), ("cdg", a, SPIN_UP)],
                                 um.jp[a, b])


def _enumerate_joint_terms(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                           um: Umatrix, bath: DmftBath,
                           hloc_anomalous, acc, eph_acc_factory):
    """Feed every joint-sector Hamiltonian term into ``acc`` (an object with
    the JointTermAccumulator interface: .occ/.dim/.states/add_diag/
    add_opstring).  Layout-agnostic: the accumulator defines the basis
    ORDER, so the same enumeration serves the sorted COO builder
    (JointTermAccumulator) and the blocked-Kron builder
    (models.joint_kron.BlockedTermAccumulator).  Returns the electron-phonon
    accumulator (from eph_acc_factory) or None."""
    ns = sec.ns
    norb, nbath, nspin = cfg.norb, cfg.nbath, cfg.nspin
    isdw = nspin - 1
    mode = cfg.ed_mode
    hloc = np.asarray(hloc, complex)
    mf = um.mf_hloc.astype(complex)
    if um.sundry and mode == "superc":
        raise ValueError("superc mode does not support generic (sundry) "
                         "two-body operators (reference parity)")

    o_up_all = acc.occ[:, :ns]
    o_dw_all = acc.occ[:, ns:]

    # ---- impurity diagonal -------------------------------------------
    e_up = np.real(np.diag(hloc[0, 0]) + np.diag(mf[0, 0])) - cfg.xmu
    e_dw = np.real(np.diag(hloc[isdw, isdw]) + np.diag(mf[1, 1])) - cfg.xmu
    sfz = np.asarray(cfg.spin_field_z[:norb])
    if mode == "nonsu2" and np.any(sfz != 0):
        e_up = e_up + sfz
        e_dw = e_dw - sfz
    acc.add_diag(o_up_all[:, :norb] @ e_up + o_dw_all[:, :norb] @ e_dw)

    # ---- impurity hopping (same spin), h.c.-filled via conjg ---------
    def add_hop(i_lvl, j_lvl, spin, amp):
        """H += amp * c†_{i,spin} c_{j,spin}.

        Note on the reference's conjugates: it fills the (source, target)
        slot of H and therefore inserts conj(amp); this builder fills
        (target, source) = <t|O|s>, so coefficients enter directly."""
        if amp == 0:
            return
        acc.add_opstring([("c", j_lvl, spin), ("cdg", i_lvl, spin)], amp)

    for s, himp in ((SPIN_UP, hloc[0, 0] + mf[0, 0]),
                    (SPIN_DW, hloc[isdw, isdw] + mf[1, 1])):
        for i in range(norb):
            for j in range(norb):
                if i != j:
                    add_hop(i, j, s, himp[i, j])

    # nonsu2: impurity spin-flip blocks + spin fields x/y + exc fields
    if mode == "nonsu2":
        for (s1, s2) in ((0, 1), (1, 0)):
            blk = hloc[s1, s2] + mf[s1, s2]
            for i in range(norb):
                for j in range(norb):
                    if blk[i, j] != 0:
                        acc.add_opstring([("c", j, s2), ("cdg", i, s1)],
                                         blk[i, j])
        sfx = np.asarray(cfg.spin_field_x[:norb])
        sfy = np.asarray(cfg.spin_field_y[:norb])
        for a in range(norb):
            if sfx[a] != 0 or sfy[a] != 0:
                # F_x S^x + F_y S^y = F_x(c†↑c↓ + c†↓c↑) - i F_y(c†↑c↓ - c†↓c↑)
                acc.add_opstring([("c", a, SPIN_DW), ("cdg", a, SPIN_UP)],
                                 sfx[a] - 1j * sfy[a])
                acc.add_opstring([("c", a, SPIN_UP), ("cdg", a, SPIN_DW)],
                                 sfx[a] + 1j * sfy[a])
        exc = np.asarray(cfg.exc_field)
        if np.any(exc != 0):
            for a in range(norb):
                for b in range(norb):
                    if a == b:
                        continue
                    add_hop(a, b, SPIN_UP, exc[0] + exc[3])
                    add_hop(a, b, SPIN_DW, exc[0] - exc[3])
                    # (Fx - iFy) c†_{a,up} c_{b,dw} + (Fx + iFy) c†_{a,dw} c_{b,up}
                    # (reference ED_NONSU2/stored/Himp.f90:175-220)
                    acc.add_opstring([("c", b, SPIN_DW), ("cdg", a, SPIN_UP)],
                                     exc[1] - 1j * exc[2])
                    acc.add_opstring([("c", b, SPIN_UP), ("cdg", a, SPIN_DW)],
                                     exc[1] + 1j * exc[2])

    # superc: impurity anomalous + pair field
    if mode == "superc":
        han = (np.asarray(hloc_anomalous, complex)
               if hloc_anomalous is not None else np.zeros((norb, norb), complex))
        pf = np.asarray(cfg.pair_field[:norb])
        for a in range(norb):
            for b in range(norb):
                # (an + pf) c†_{a,up} c†_{b,dw} + (conj(an) + pf) c_{b,dw} c_{a,up}
                # (reference Himp.f90 pair blocks, slot convention unfolded)
                amp_ann = np.conj(han[a, b]) + (pf[a] if a == b else 0.0)
                amp_cre = han[a, b] + (pf[a] if a == b else 0.0)
                if amp_ann != 0:
                    acc.add_opstring([("c", a, SPIN_UP), ("c", b, SPIN_DW)],
                                     amp_ann)
                if amp_cre != 0:
                    acc.add_opstring([("cdg", b, SPIN_DW), ("cdg", a, SPIN_UP)],
                                     amp_cre)

    # ---- interaction --------------------------------------------------
    _interaction_diag(acc, cfg, um, norb)
    if norb > 1:
        _jxjp_terms(acc, um, norb)
    if um.sundry and mode == "nonsu2":
        for t in um.sundry:
            acc.add_opstring(list(t.ops), t.coeff)

    # ---- bath ----------------------------------------------------------
    ediag = bath_levels(bath)
    vhyb = bath_hyb(bath)
    hb = bath.hbath() if bath.is_replica else None
    if not bath.is_replica:
        d_b = np.zeros(acc.dim)
        for i in range(ediag.shape[1]):
            for k in range(nbath):
                lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                d_b += ediag[0, i, k] * o_up_all[:, lb]
                d_b += ediag[isdw, i, k] * o_dw_all[:, lb]
        acc.add_diag(d_b)
        if mode == "superc" and bath.d is not None:
            for i in range(bath.d.shape[1]):
                for k in range(nbath):
                    lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                    dk = bath.d[0, i, k]
                    if dk != 0:
                        acc.add_opstring([("c", lb, SPIN_UP), ("c", lb, SPIN_DW)], dk)
                        acc.add_opstring([("cdg", lb, SPIN_DW), ("cdg", lb, SPIN_UP)], dk)
        if mode == "nonsu2" and bath.u is not None:
            for i in range(norb):
                for k in range(nbath):
                    lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                    u1 = bath.u[0, i, k]
                    u2 = bath.u[isdw, i, k]
                    if u1 != 0:
                        # imp up <-> bath dw (reference Himp_bath.f90:82-103)
                        acc.add_opstring([("c", i, SPIN_UP), ("cdg", lb, SPIN_DW)], u1)
                        acc.add_opstring([("c", lb, SPIN_DW), ("cdg", i, SPIN_UP)], u1)
                    if u2 != 0:
                        acc.add_opstring([("c", i, SPIN_DW), ("cdg", lb, SPIN_UP)], u2)
                        acc.add_opstring([("c", lb, SPIN_UP), ("cdg", i, SPIN_DW)], u2)
    else:
        # replica/general bath
        if mode == "superc":
            # Nambu-form replica: hb (Nbath, 2, 2, Norb, Norb):
            # (0,0) normal block h; (1,1) = -h^T encoded; (0,1)/(1,0) pairing
            d_b = np.zeros(acc.dim)
            for k in range(nbath):
                h11 = np.real(np.diag(hb[k, 0, 0]))
                h22 = np.real(np.diag(hb[k, 1, 1])) if hb.shape[1] > 1 else -h11
                for i in range(norb):
                    lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                    d_b += h11[i] * o_up_all[:, lb]
                    d_b -= h22[i] * o_dw_all[:, lb]
                for i in range(norb):
                    for j in range(norb):
                        li = bath_level(cfg.bath_type, norb, nbath, i, k)
                        lj = bath_level(cfg.bath_type, norb, nbath, j, k)
                        if i != j and hb[k, 0, 0, i, j] != 0:
                            # h00[i,j] c†_{i,up} c_{j,up}
                            acc.add_opstring([("c", lj, SPIN_UP),
                                              ("cdg", li, SPIN_UP)],
                                             hb[k, 0, 0, i, j])
                        if i != j and hb.shape[1] > 1 and hb[k, 1, 1, i, j] != 0:
                            # Nambu (2,2) block: conj(h11[i,j]) c_{j,dw} c†_{i,dw}
                            # = -conj(h11[i,j]) c†_{i,dw} c_{j,dw} for i != j
                            # (reference Hbath.f90 inverted-order application)
                            acc.add_opstring([("cdg", li, SPIN_DW),
                                              ("c", lj, SPIN_DW)],
                                             np.conj(hb[k, 1, 1, i, j]))
                        if hb.shape[1] > 1 and hb[k, 0, 1, i, j] != 0:
                            # conj(h01[i,j]) c_{j,dw} c_{i,up}
                            acc.add_opstring([("c", li, SPIN_UP),
                                              ("c", lj, SPIN_DW)],
                                             np.conj(hb[k, 0, 1, i, j]))
                        if hb.shape[1] > 1 and hb[k, 1, 0, i, j] != 0:
                            # conj(h10[i,j]) c†_{j,up} c†_{i,dw}
                            acc.add_opstring([("cdg", li, SPIN_DW),
                                              ("cdg", lj, SPIN_UP)],
                                             np.conj(hb[k, 1, 0, i, j]))
        else:
            d_b = np.zeros(acc.dim)
            for k in range(nbath):
                for s1 in range(2):
                    s1h = min(s1, hb.shape[1] - 1)
                    dg = np.real(np.diag(hb[k, s1h, s1h]))
                    for i in range(norb):
                        lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                        d_b += dg[i] * (o_up_all[:, lb] if s1 == 0
                                        else o_dw_all[:, lb])
                for s1 in range(hb.shape[1]):
                    for s2 in range(hb.shape[2]):
                        blk = hb[k, s1, s2]
                        for i in range(norb):
                            for j in range(norb):
                                if (s1 == s2 and i == j) or blk[i, j] == 0:
                                    continue
                                li = bath_level(cfg.bath_type, norb, nbath, i, k)
                                lj = bath_level(cfg.bath_type, norb, nbath, j, k)
                                acc.add_opstring([("c", lj, s2), ("cdg", li, s1)],
                                                 blk[i, j])
        acc.add_diag(d_b)
    # hybridization (all modes, all bath types)
    for s in (SPIN_UP, SPIN_DW):
        sidx = 0 if s == SPIN_UP else isdw
        for i in range(norb):
            for k in range(nbath):
                v = vhyb[sidx, i, k]
                if v == 0:
                    continue
                lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                acc.add_opstring([("c", i, s), ("cdg", lb, s)], v)
                acc.add_opstring([("c", lb, s), ("cdg", i, s)], v)

    # ---- phonons (terms only; grids/couplings attached by the caller) --
    acc2 = None
    if cfg.nph > 0:
        g = g_ph_matrix(cfg)
        acc.eph_diag = (o_up_all[:, :norb] + o_dw_all[:, :norb]) @ np.diag(g)
        acc2 = eph_acc_factory()
        for s in (SPIN_UP, SPIN_DW):
            for i in range(norb):
                for j in range(norb):
                    if i != j and g[i, j] != 0:
                        acc2.add_opstring([("c", j, s), ("cdg", i, s)], g[i, j])
    return acc2


def build_joint_sector_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                          um: Umatrix, bath: DmftBath,
                          hloc_anomalous: Optional[np.ndarray] = None
                          ) -> JointSectorOp:
    """Assemble the joint-sector H for superc or nonsu2 (sorted COO/ELL)."""
    ns = sec.ns
    acc = JointTermAccumulator(sec.states, ns)
    acc2 = _enumerate_joint_terms(cfg, sec, hloc, um, bath, hloc_anomalous,
                                  acc, lambda: JointTermAccumulator(
                                      sec.states, ns))
    rows, cols, vals = acc.coo()
    op = JointSectorOp(sector=sec, dim_el=acc.dim, rows=rows, cols=cols,
                       vals=vals, diag=acc.diag)
    if cfg.nph > 0:
        op.ph_mat, op.ph_x = _phonon_matrices(cfg)
        op.eph_diag = acc.eph_diag
        op.eph_rows, op.eph_cols, op.eph_vals = acc2.coo()
    return op
