"""The plain reference of the benchmark: an impurity Anderson model with a
Kanamori interaction, normal or s-wave superconducting (normal bath, one
bath level set per orbital), solved from its definition.

H = Σ_{aσ} (Hloc_aa - xmu) n_aσ + Σ_{akσ} e_ak n_{akσ}
    + Σ_{akσ} v_ak (c†_{akσ} c_aσ + h.c.)
    + Σ_ak d_ak (c†_{ak↑} c†_{ak↓} + h.c.)                     (superc)
    + Σ_a U_a (n_a↑ - ½)(n_a↓ - ½)
    + Σ_{a<b} [Ust Σ_σ (n_aσ - ½)(n_b,-σ - ½) + (Ust - Jh) Σ_σ (n_aσ - ½)(n_bσ - ½)]
    + Σ_{a≠b} [Jx c†_a↑ c†_b↓ c_a↓ c_b↑ + Jp c†_a↑ c†_a↓ c_b↓ c_b↑]

(EDIpack's Kanamori Hamiltonian with its Hartree shifts, ``hfmode``).
A state is (u, d), up register times down register; a vector is a (du, dd)
matrix V[u, d]. Normal mode: a sector (Nup, Ndw) is the product of the two
fixed-N registers. Superc: a sector Sz = Nup - Ndw is a set of (u, d) pairs
of the two full registers; its vectors are stored as that list's
entries and the operator acts on the full (2^ns, 2^ns) grid.

Every term is a product of an up-register and a down-register operator:
H V = D ⊙ V + H1u V + V H1dᵀ + Σ_t c_t A_t V B_tᵀ, the one-body parts as
dense matrices, the two-spin terms (Jx, Jp, pairing) as signed pull maps.

From a sector's ground states it computes the kept levels, the Green's
functions by m-step Lanczos chains (the Källén-Lehmann weights and poles of
each chain's tridiagonal matrix), the self-energy from Dyson's equation,
and the static observables. The working precision is a constructor
argument, so that the same code computes the lower-precision control.

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import fermions as fm
from . import lanczos

UP, DW = 0, 1


class Model:
    """The model of one configuration and one bath.

    ``cfg``: the configuration's parameters (norb, nbath, ed_mode, uloc,
    ust, jh, jx, jp, xmu, beta, lmats, gs_threshold, lanc_ngfiter, hfmode).
    ``bath``: dict of (norb, nbath) arrays ``e``, ``v`` and in superc ``d``.
    ``hloc``: the diagonal of the impurity's Hloc (norb,), both spins
    alike; zero when None.
    """

    def __init__(self, cfg: dict, bath: Dict[str, np.ndarray],
                 dtype: torch.dtype, device, hloc=None):
        self.cfg = cfg
        self.superc = cfg["ed_mode"] == "superc"
        self.norb, self.nbath = cfg["norb"], cfg["nbath"]
        self.ns = self.norb * (self.nbath + 1)
        self.e = np.asarray(bath["e"], float).reshape(self.norb, self.nbath)
        self.v = np.asarray(bath["v"], float).reshape(self.norb, self.nbath)
        self.d = (np.asarray(bath["d"], float).reshape(self.norb, self.nbath)
                  if self.superc else None)
        self.dtype = dtype
        self.device = torch.device(device)
        self.hloc = np.zeros(self.norb) if hloc is None \
            else np.asarray(hloc, float).reshape(self.norb)
        self._ops: Dict[Tuple, "SectorOp"] = {}
        uloc = np.asarray(cfg["uloc"], float)[:self.norb]
        off = 1.0 - np.eye(self.norb)
        self.uloc = uloc
        self.ust = cfg["ust"] * off
        self.ustp = (cfg["ust"] - cfg["jh"]) * off
        self.jx = cfg["jx"] * off
        self.jp = cfg["jp"] * off

    # -- levels ----------------------------------------------------------
    def bath_level(self, a: int, k: int) -> int:
        return self.norb + a * self.nbath + k

    def level_energies(self) -> np.ndarray:
        """One-body level energies (both spins alike), with the Hartree
        shifts of the impurity levels."""
        e = np.zeros(self.ns)
        e[:self.norb] = self.hloc - self.cfg.get("xmu", 0.0)
        if self.cfg.get("hfmode", True):
            e[:self.norb] += -0.5 * self.uloc \
                - 0.5 * (self.ust.sum(1) + self.ustp.sum(1))
        for a in range(self.norb):
            for k in range(self.nbath):
                e[self.bath_level(a, k)] += self.e[a, k]
        return e

    def hop_terms(self) -> List[Tuple[int, int, float]]:
        out = []
        for a in range(self.norb):
            for k in range(self.nbath):
                lb = self.bath_level(a, k)
                out += [(lb, a, self.v[a, k]), (a, lb, self.v[a, k])]
        return out

    def const(self) -> float:
        if not self.cfg.get("hfmode", True):
            return 0.0
        return 0.25 * self.uloc.sum() + 0.25 * (self.ust.sum()
                                                + self.ustp.sum())

    # -- sectors ---------------------------------------------------------
    def op(self, label: Tuple[int, ...]) -> "SectorOp":
        """The operator of a sector: (nup, ndw) or (sz,)."""
        if label not in self._ops:
            self._ops[label] = SectorOp(self, label)
        return self._ops[label]

    def free(self) -> None:
        self._ops.clear()

    # -- solve -----------------------------------------------------------
    def lowest(self, label, nev: int, seed: int = 7):
        """The lowest ``nev`` levels of a sector: (energies, vectors); a
        sector of at most ``DENSE_DIM`` states is diagonalized whole."""
        op = self.op(label)
        if op.dim <= DENSE_DIM:
            eye = torch.eye(op.dim, dtype=self.dtype, device=self.device)
            h = op.matvec(eye).T                 # column j: H e_j
            vals, vecs = torch.linalg.eigh((h + h.conj().T) / 2)
            n = min(nev, op.dim)
            return vals[:n].double().cpu().numpy(), vecs[:, :n].T, {}
        g = torch.Generator(device="cpu").manual_seed(seed)
        x = torch.randn(nev, op.dim, generator=g, dtype=torch.float64)
        x = x.to(self.dtype).to(self.device)
        eps = torch.finfo(self.dtype).eps
        tol = max(1e-11, 200 * eps)
        vals, vecs, stats = lanczos.lowest(op.matvec, x, nev, tol)
        return vals, vecs, stats

    def kept(self, labels, nev: int):
        """The kept states at T=0 over the sectors ``labels``: every level
        within the ground window of the lowest; [(label, E, vector)]."""
        found = []
        for lab in labels:
            vals, vecs, _ = self.lowest(lab, nev)
            found += [(lab, float(vals[i]), vecs[i]) for i in range(len(vals))]
        e0 = min(f[1] for f in found)
        eps = float(torch.finfo(self.dtype).eps)
        window = max(self.cfg["gs_threshold"], 8 * eps * abs(e0))
        return [f for f in found if f[1] - e0 <= window]

    def weights(self, energies: np.ndarray) -> np.ndarray:
        e = np.asarray(energies)
        w = np.exp(-self.cfg["beta"] * (e - e.min()))
        return w / w.sum()

    # -- Green's functions ------------------------------------------------
    def greens(self, kept, z: np.ndarray) -> Dict[str, np.ndarray]:
        """G (norb, L) on ``z``; in superc also barG and F (norb, L) on z
        and F on conj(z). Each chain channel: |φ> = O|ψ>, poles sgn·(E_n-E)."""
        w = self.weights([k[1] for k in kept])
        m = self.cfg["lanc_ngfiter"]
        out = {}

        def acc(name, coeff, wts, poles, sgn, e, zz):
            val = (coeff * wts[None, :]
                   / (zz[:, None] - sgn * (poles[None, :] - e))).sum(1)
            out[name] = out.get(name, 0) + val

        grids = {"": z} if not self.superc else {"": z, "_conj": np.conj(z)}
        for (lab, e, vec), ws in zip(kept, w):
            src = self.op(lab)
            # channels: (name, target label, [(kind, orb, spin, coeff)],
            # prefactor, sign of the poles)
            chans = []
            for a in range(self.norb):
                chans.append((("g", a), self.shift(lab, 0, +1),
                              [("cdg", a, UP, 1.0)], 1.0, +1))
                chans.append((("g", a), self.shift(lab, 0, -1),
                              [("c", a, UP, 1.0)], 1.0, -1))
                if self.superc:
                    chans.append((("barg", a), self.shift(lab, 1, -1),
                                  [("c", a, DW, 1.0)], 1.0, +1))
                    chans.append((("barg", a), self.shift(lab, 1, +1),
                                  [("cdg", a, DW, 1.0)], 1.0, -1))
                    p, h = self.shift(lab, 0, +1), self.shift(lab, 0, -1)
                    chans += [
                        (("faux", a), p, [("cdg", a, UP, 1.0),
                                          ("c", a, DW, 1.0)], 1.0, +1),
                        (("faux", a), h, [("c", a, UP, 1.0),
                                          ("cdg", a, DW, 1.0)], 1.0, -1),
                        (("faux", a), p, [("cdg", a, UP, 1.0),
                                          ("c", a, DW, 1j)], -1j, +1),
                        (("faux", a), h, [("c", a, UP, 1.0),
                                          ("cdg", a, DW, -1j)], -1j, -1)]
            by_target: Dict[Tuple, list] = {}
            for ch in chans:
                if ch[1] is not None:
                    by_target.setdefault(ch[1], []).append(ch)
            for tgt, items in by_target.items():
                top = self.op(tgt)
                phis = torch.stack([src.excite(vec, top, ops)
                                    for _, _, ops, _, _ in items])
                res = lanczos.chains(top.matvec, phis, min(m, top.dim))
                for (key, _, _, pref, sgn), (wts, poles) in zip(items, res):
                    for suffix, zz in grids.items():
                        acc(key + (suffix,), ws * pref, wts, poles, sgn, e,
                            zz)
        res = {"g": np.array([out[("g", a, "")] for a in range(self.norb)])}
        if self.superc:
            for suffix in ("", "_conj"):
                gg = np.array([out[("g", a, suffix)]
                               for a in range(self.norb)])
                bg = np.array([out[("barg", a, suffix)]
                               for a in range(self.norb)])
                fa = np.array([out[("faux", a, suffix)]
                               for a in range(self.norb)])
                # F_aa = (faux - (1 - i)(G_aa + barG_aa)) / 2
                res["f" + suffix] = 0.5 * (fa - (1 - 1j) * (gg + bg))
        return res

    def shift(self, lab, spin: int, step: int):
        """Label of the sector after adding (step +1) or removing (-1) one
        particle of ``spin``; None when it does not exist."""
        if self.superc:
            sz = lab[0] + (step if spin == UP else -step)
            return (sz,) if abs(sz) <= self.ns else None
        n = list(lab)
        n[spin] += step
        if not 0 <= n[spin] <= self.ns:
            return None
        return tuple(n)

    def sigma(self, z: np.ndarray, gf: Dict[str, np.ndarray]) -> np.ndarray:
        """Σ(z) (norb, L) by Dyson's equation (Nambu in superc)."""
        e, v = self.e, self.v
        if not self.superc:
            delta = (v[:, :, None] ** 2
                     / (z[None, None, :] - e[:, :, None])).sum(1)
            invg0 = z[None, :] + self.cfg.get("xmu", 0.0) \
                - self.hloc[:, None] - delta
            return invg0 - 1.0 / gf["g"]
        d = self.d
        den = z[None, None, :] ** 2 - (e ** 2 + d ** 2)[:, :, None]
        delta = (v[:, :, None] ** 2 * (z[None, None, :] + e[:, :, None])
                 / den).sum(1)
        invg0 = z[None, :] + self.cfg.get("xmu", 0.0) - self.hloc[:, None] \
            - delta
        g, f, f21 = gf["g"], gf["f"], gf["f_conj"]
        # per orbital, the Nambu matrix [[G, F], [conj(F(z*)), -conj(G)]]
        m11, m12, m21, m22 = g, f, np.conj(f21), -np.conj(g)
        det = m11 * m22 - m12 * m21
        return invg0 - m22 / det

    # -- observables -------------------------------------------------------
    def observables(self, kept) -> Dict[str, np.ndarray]:
        """dens, docc (norb,), energies (epot, eint, ehartree, eknot), and in
        superc phi (norb,) = |<c_a↑ c_a↓>|."""
        w = self.weights([k[1] for k in kept])
        no = self.norb
        dens, docc = np.zeros(no), np.zeros(no)
        eint = ehart = eknot = 0.0
        phi = np.zeros(no, complex)
        for (lab, _, vec), ws in zip(kept, w):
            op = self.op(lab)
            p = op.grid(vec.abs() ** 2).double().cpu().numpy()   # (du, dd)
            ou = fm.occupations(op.ubasis, self.ns)[:, :no]
            od = fm.occupations(op.dbasis, self.ns)[:, :no]
            pu, pd = p.sum(1), p.sum(0)
            nu, nd = pu @ ou, pd @ od
            q_ud = ou.T @ p @ od              # <n_a↑ n_b↓>
            q_uu = ou.T @ (pu[:, None] * ou)
            q_dd = od.T @ (pd[:, None] * od)
            dens += ws * (nu + nd)
            docc += ws * np.diag(q_ud)
            eknot += ws * float(self.hloc @ (nu + nd))
            ei = float(self.uloc @ np.diag(q_ud))
            for a in range(no):
                for b in range(a + 1, no):
                    ei += self.ust[a, b] * (q_ud[a, b] + q_ud[b, a])
                    ei += self.ustp[a, b] * (q_uu[a, b] + q_dd[a, b])
            ei += float(np.real(op.expect_nonlocal(vec)))
            eint += ws * ei
            if self.cfg.get("hfmode", True):
                n = nu + nd
                eh = -0.5 * float(self.uloc @ n) + 0.25 * self.uloc.sum()
                for a in range(no):
                    for b in range(a + 1, no):
                        c = self.ust[a, b] + self.ustp[a, b]
                        eh += -0.5 * c * (n[a] + n[b]) + 0.5 * c
                ehart += ws * eh
            if self.superc:
                for a in range(no):
                    phi[a] += ws * op.expect(vec, [("c", a, DW), ("c", a, UP)])
        out = dict(dens=dens, docc=docc,
                   energies=np.array([eint + ehart, eint, ehart, eknot]))
        if self.superc:
            out["phi"] = np.abs(phi)
        return out


# a sector of at most this many states is diagonalized as a dense matrix
DENSE_DIM = 512

# a one-spin matrix of more rows than this is kept as sparse CSR
SPARSE_ROWS = 1024


def _operator(h: np.ndarray, dt: torch.dtype, dev) -> torch.Tensor:
    t = torch.as_tensor(h, device=dev).to(dt)
    return t.to_sparse_csr() if h.shape[0] > SPARSE_ROWS else t


def _left(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h @ x[i] for every i of x (B, m, p)."""
    if h.layout != torch.sparse_csr:
        return h @ x
    bsz, m, p = x.shape
    y = h @ x.permute(1, 0, 2).reshape(m, bsz * p)
    return y.reshape(m, bsz, p).permute(1, 0, 2)


class SectorOp:
    """H on one sector of a :class:`Model`, in the model's dtype."""

    def __init__(self, model: Model, label: Tuple[int, ...]):
        self.model = model
        self.label = label
        dev, dt = model.device, model.dtype
        ns, no = model.ns, model.norb
        if model.superc:
            self.ubasis = self.dbasis = fm.basis(ns)
            nu = fm.popcount(self.ubasis)
            sz = nu[:, None] - nu[None, :]
            flat = np.nonzero((sz == label[0]).ravel())[0]
            self.index = torch.as_tensor(flat, device=dev)
            self.dim = len(flat)
        else:
            self.ubasis = fm.basis(ns, label[0])
            self.dbasis = fm.basis(ns, label[1])
            self.index = None
            self.dim = len(self.ubasis) * len(self.dbasis)
        self.du, self.dd = len(self.ubasis), len(self.dbasis)
        rdt = {torch.complex128: torch.float64,
               torch.complex64: torch.float32}.get(dt, dt)
        ou = torch.as_tensor(fm.occupations(self.ubasis, ns), dtype=rdt,
                             device=dev)
        od = torch.as_tensor(fm.occupations(self.dbasis, ns), dtype=rdt,
                             device=dev)
        lev = torch.as_tensor(model.level_energies(), dtype=rdt, device=dev)
        d = (ou @ lev)[:, None] + (od @ lev)[None, :] + model.const()
        iu, idw = ou[:, :no], od[:, :no]
        mx = torch.as_tensor(np.diag(model.uloc) + model.ust, dtype=rdt,
                             device=dev)
        d = d + iu @ mx @ idw.T
        pp = torch.as_tensor(model.ustp, dtype=rdt, device=dev)
        d = d + 0.5 * ((iu @ pp) * iu).sum(1)[:, None] \
            + 0.5 * ((idw @ pp) * idw).sum(1)[None, :]
        self.diag = d.to(dt)
        h1u = fm.one_body_matrix(self.ubasis, model.hop_terms())
        h1d = h1u if model.superc else \
            fm.one_body_matrix(self.dbasis, model.hop_terms())
        self.h1u, self.h1d = _operator(h1u, dt, dev), _operator(h1d, dt, dev)
        self.terms = []
        for coeff, ops in self._two_spin_strings():
            self.terms.append((coeff,) + self._kron(ops))

    def _two_spin_strings(self):
        m = self.model
        out = []
        for a in range(m.norb):
            for b in range(m.norb):
                if a == b:
                    continue
                if m.jx[a, b] != 0:
                    out.append((m.jx[a, b], [("c", b, UP), ("c", a, DW),
                                             ("cdg", b, DW), ("cdg", a, UP)]))
                if m.jp[a, b] != 0:
                    out.append((m.jp[a, b], [("c", b, UP), ("c", b, DW),
                                             ("cdg", a, DW), ("cdg", a, UP)]))
        self.n_nonlocal = len(out)
        if m.superc:
            for a in range(m.norb):
                for k in range(m.nbath):
                    lb, dk = m.bath_level(a, k), m.d[a, k]
                    if dk != 0:
                        out.append((dk, [("c", lb, UP), ("c", lb, DW)]))
                        out.append((dk, [("cdg", lb, DW), ("cdg", lb, UP)]))
        return out

    def _maps(self, ops):
        """(up map, down map) of a joint string within this sector's
        registers (fixed-N in normal mode, full in superc)."""
        m = self.model
        reg = None if m.superc else (lambda n: fm.basis(m.ns, n))
        ups, dws = fm.joint_string(self.ubasis, reg, self.dbasis, reg,
                                   [(k, lvl, s) for k, lvl, s in ops])
        return fm.compose(ups, self.du), fm.compose(dws, self.dd)

    def _kron(self, ops):
        mu, md = self._maps(ops)
        dev, dt = self.model.device, self.model.dtype
        return (torch.as_tensor(mu.src, device=dev),
                torch.as_tensor(mu.sgn, device=dev).to(dt),
                torch.as_tensor(md.src, device=dev),
                torch.as_tensor(md.sgn, device=dev).to(dt))

    # -- layouts -----------------------------------------------------------
    def grid(self, v: torch.Tensor) -> torch.Tensor:
        """Sector vector(s) (..., dim) -> (..., du, dd)."""
        if self.index is None:
            return v.reshape(v.shape[:-1] + (self.du, self.dd))
        full = torch.zeros(v.shape[:-1] + (self.du * self.dd,),
                           dtype=v.dtype, device=v.device)
        full[..., self.index] = v
        return full.reshape(v.shape[:-1] + (self.du, self.dd))

    def flat(self, g: torch.Tensor) -> torch.Tensor:
        g = g.reshape(g.shape[:-2] + (self.du * self.dd,))
        return g if self.index is None else g[..., self.index]

    # -- products ----------------------------------------------------------
    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H applied to the rows of v (B, dim)."""
        x = self.grid(v)                                   # (B, du, dd)
        y = self.diag * x + _left(self.h1u, x) \
            + _left(self.h1d, x.transpose(1, 2)).transpose(1, 2)
        for coeff, su, gu, sd, gd in self.terms:
            t = x.index_select(1, su).index_select(2, sd)
            y = y + coeff * gu[None, :, None] * gd[None, None, :] * t
        return self.flat(y)

    def excite(self, vec: torch.Tensor, target: "SectorOp", ops) -> torch.Tensor:
        """Σ_k coeff_k O_k |vec> in ``target``'s layout; ops: [(kind, orb,
        spin, coeff)], each one operator."""
        x = self.grid(vec)
        out = torch.zeros(target.du, target.dd, dtype=x.dtype,
                          device=x.device)
        for kind, orb, spin, coeff in ops:
            mu, md = self._target_maps(target, [(kind, orb, spin)])
            su = torch.as_tensor(mu.src, device=x.device)
            sd = torch.as_tensor(md.src, device=x.device)
            gu = torch.as_tensor(mu.sgn, device=x.device).to(x.dtype)
            gd = torch.as_tensor(md.sgn, device=x.device).to(x.dtype)
            out = out + coeff * gu[:, None] * gd[None, :] \
                * x.index_select(0, su).index_select(1, sd)
        return target.flat(out)

    def _target_maps(self, target: "SectorOp", ops):
        m = self.model
        if m.superc:
            ups, dws = fm.joint_string(self.ubasis, None, self.dbasis, None,
                                       ops)
        else:
            reg = lambda n: fm.basis(m.ns, n)
            ups, dws = fm.joint_string(self.ubasis, reg, self.dbasis, reg,
                                       ops)
        return fm.compose(ups, self.du), fm.compose(dws, self.dd)

    def expect(self, vec: torch.Tensor, ops) -> complex:
        """<vec| O |vec> of one joint string O within the sector."""
        mu, md = self._target_maps(self, ops)
        x = self.grid(vec)
        dev = x.device
        t = x.index_select(0, torch.as_tensor(mu.src, device=dev)) \
            .index_select(1, torch.as_tensor(md.src, device=dev))
        gu = torch.as_tensor(mu.sgn, device=dev).to(x.dtype)
        gd = torch.as_tensor(md.sgn, device=dev).to(x.dtype)
        return complex((x.conj() * gu[:, None] * gd[None, :] * t).sum())

    def expect_nonlocal(self, vec: torch.Tensor) -> complex:
        """<vec| Jx and Jp terms |vec>."""
        x = self.grid(vec)
        tot = 0.0
        for coeff, su, gu, sd, gd in self.terms[:self.n_nonlocal]:
            t = x.index_select(0, su).index_select(1, sd)
            tot += coeff * complex((x.conj() * gu[:, None] * gd[None, :]
                                    * t).sum())
        return tot
