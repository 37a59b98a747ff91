"""Replica/general bath matrix basis: H_k = sum_s lambda_k(s) O_s.

Parity target: reference ED_BATH/ED_BATH_REPLICA.f90 (:124-145): the user
provides a basis of (Nspin,Nspin,Norb,Norb) Hermitian matrices O_s and initial
lambda values per replica; each bath replica k carries its own lambda vector.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ReplicaBasis:
    ops: np.ndarray    # (Nsym, Nspin, Nspin, Norb, Norb) complex
    linit: np.ndarray  # (Nbath, Nsym) initial lambdas

    def __post_init__(self):
        self.ops = np.asarray(self.ops, dtype=np.complex128)
        self.linit = np.asarray(self.linit, dtype=np.float64)
        if self.ops.ndim != 5:
            raise ValueError("basis ops must have shape (Nsym,Nspin,Nspin,Norb,Norb)")
        if self.linit.ndim != 2 or self.linit.shape[1] != self.ops.shape[0]:
            raise ValueError("linit must have shape (Nbath, Nsym)")
        for s in range(self.nsym):
            m = self._flat(s)
            if not np.allclose(m, m.conj().T, atol=1e-12):
                raise ValueError(f"basis operator {s} is not Hermitian")

    @property
    def nsym(self) -> int:
        return self.ops.shape[0]

    @property
    def nbath(self) -> int:
        return self.linit.shape[0]

    def _flat(self, s: int) -> np.ndarray:
        ns, no = self.ops.shape[1], self.ops.shape[3]
        return self.ops[s].transpose(0, 2, 1, 3).reshape(ns * no, ns * no)

    def is_diagonal(self, s: int) -> bool:
        m = self._flat(s)
        return bool(np.allclose(m, np.diag(np.diag(m)), atol=1e-12))

    def is_identity(self, s: int) -> bool:
        m = self._flat(s)
        d = np.diag(m)
        return self.is_diagonal(s) and bool(np.allclose(d, d[0]) and d[0] != 0)


def make_basis(ops, lambdas, nbath: int = None) -> ReplicaBasis:
    """Accept (Nsym,Nspin,Nspin,Norb,Norb) ops with lambdas given either as
    (Nbath,Nsym) or a single (Nsym,) vector replicated over baths
    (reference init_Hreplica_symmetries_* overloads)."""
    ops = np.asarray(ops)
    lam = np.asarray(lambdas, dtype=np.float64)
    if lam.ndim == 1:
        if nbath is None:
            raise ValueError("nbath required when lambdas is a single vector")
        lam = np.tile(lam[None, :], (nbath, 1))
    return ReplicaBasis(ops, lam)


def save_hbasis(basis: ReplicaBasis, path: str) -> None:
    """Write the matrix basis in the reference's Bfile format
    (ED_BATH_REPLICA.f90:203-233): first line Nsym; then per symmetry, one
    line per (ispin, iorb) holding O(ispin, jspin, iorb, jorb) as Fortran
    complex tuples with jorb fastest within jspin."""
    nsym, ns = basis.nsym, basis.ops.shape[1]
    no = basis.ops.shape[3]
    with open(path, "w") as f:
        f.write(f" {nsym}\n")
        for k in range(nsym):
            for s1 in range(ns):
                for a in range(no):
                    vals = [basis.ops[k, s1, s2, a, b]
                            for s2 in range(ns) for b in range(no)]
                    f.write(" " + "  ".join(
                        f"({v.real:.12f},{v.imag:.12f})" for v in vals) + "\n")
            f.write("\n")


def read_hbasis(path: str, nspin: int, norb: int,
                linit=None) -> ReplicaBasis:
    """Read a Bfile written by save_hbasis / the reference save_Hreplica."""
    import re as _re
    tok = _re.compile(r"\(\s*([^,()\s]+)\s*,\s*([^,()\s]+)\s*\)")
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()]
    nsym = int(lines[0].split()[0])
    ops = np.zeros((nsym, nspin, nspin, norb, norb), complex)
    li = 1
    for k in range(nsym):
        for s1 in range(nspin):
            for a in range(norb):
                while li < len(lines) and not lines[li].strip():
                    li += 1
                vals = [complex(float(m.group(1)), float(m.group(2)))
                        for m in tok.finditer(lines[li])]
                li += 1
                idx = 0
                for s2 in range(nspin):
                    for b in range(norb):
                        ops[k, s1, s2, a, b] = vals[idx]
                        idx += 1
    if linit is None:
        linit = np.zeros((1, nsym))
    return ReplicaBasis(ops, np.asarray(linit, float))
