"""Krylov routines of the plain reference, in plain PyTorch.

* :func:`lowest` — the lowest ``nev`` eigenpairs of a Hermitian operator by
  block Lanczos with full reorthogonalization, restarted from its Ritz
  vectors when the basis reaches ``max_basis`` vectors.
* :func:`chains` — independent storage-free Lanczos tridiagonalizations
  (no reorthogonalization) of several start vectors, one operator call a
  step on the stacked block, and the weights and poles of each chain's
  tridiagonal matrix.

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _qr_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, n) = r @ q: q (b, n) has orthonormal rows, r (b, b) lower
    triangular (Gram-Schmidt over the rows, each row twice)."""
    b = x.shape[0]
    q = torch.empty_like(x)
    r = torch.zeros(b, b, dtype=x.dtype, device=x.device)
    for i in range(b):
        y = x[i]
        for _ in range(2):
            if i:
                c = q[:i].conj() @ y
                r[i, :i] += c
                y = y - c @ q[:i]
        nrm = torch.linalg.norm(y)
        r[i, i] = nrm
        q[i] = y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return q, r


def lowest(matvec: Callable[[torch.Tensor], torch.Tensor], start: torch.Tensor,
           nev: int, tol: float, max_basis: int = 400, max_restarts: int = 20,
           check_every: int = 4) -> Tuple[np.ndarray, torch.Tensor, dict]:
    """Lowest ``nev`` eigenpairs; ``start`` (b, n), b >= nev, its rows the
    start block. ``matvec`` maps (b, n) -> (b, n). The basis (at most
    ``max_basis`` rows, then an explicit restart from the Ritz vectors) is
    kept orthonormal by two classical Gram-Schmidt passes a block. The
    projected block-tridiagonal problem is solved on the host in float64.
    Converged when the Ritz pairs among the lowest ``nev`` that lie within
    1e-5 * max(1, |theta_0|) of the lowest (the candidates for a
    degenerate ground multiplet, and the lowest itself) have residual norms
    at most ``tol * max(1, |theta|)``. Returns (energies (nev,), vectors
    (nev, n), stats)."""
    b, n = start.shape
    steps = max(2, max_basis // b)
    basis = torch.empty(steps * b, n, dtype=start.dtype, device=start.device)
    x = start
    stats = dict(matvecs=0, restarts=0, residual=np.inf)
    for restart in range(max_restarts + 1):
        basis[:b], _ = _qr_rows(x)
        diag, off = [], []
        j = 0
        while True:
            q = basis[j * b:(j + 1) * b]
            w = matvec(q)
            stats["matvecs"] += b
            a = q.conj() @ w.T                  # (b, b): <q_i|H q_j>
            diag.append(a)
            k = (j + 1) * b
            for _ in range(2):                  # w against the whole basis
                c = basis[:k].conj() @ w.T      # (k, b)
                w = w - c.T @ basis[:k]
            qn, r = _qr_rows(w)
            last_step = j + 1 == steps
            if (j + 1) % check_every == 0 or last_step:
                t = _block_tridiag(diag, off, b)
                evals, evecs = np.linalg.eigh(t)
                # residual of Ritz pair i: |r^T y_i| over the last block
                res = np.linalg.norm(r.cpu().numpy().T @ evecs[k - b:, :nev],
                                     axis=0)
                theta = evals[:nev]
                scale = np.maximum(np.abs(theta), 1.0)
                near = theta - theta[0] <= 1e-5 * scale[0]
                ok = bool((res[near] <= tol * scale[near]).all())
                stats["residual"] = float(res[near].max())
                if ok or last_step:
                    break
            off.append(r)
            basis[k:k + b] = qn
            j += 1
        y = torch.as_tensor(evecs[:, :b], device=start.device).to(start.dtype)
        ritz = y.T @ basis[:k]                   # (b, n)
        if ok:
            return evals[:nev], ritz[:nev], stats
        stats["restarts"] = restart + 1
        x = ritz
    return evals[:nev], ritz[:nev], stats


def _block_tridiag(diag, off, b: int) -> np.ndarray:
    """The projected matrix, on the host in float64 / complex128."""
    k = len(diag) * b
    cplx = diag[0].is_complex()
    t = np.zeros((k, k), complex if cplx else float)
    for i, a in enumerate(diag):
        a = a.cpu().numpy()
        t[i * b:(i + 1) * b, i * b:(i + 1) * b] = (a + a.conj().T) / 2
    for i, r in enumerate(off):
        r = r.cpu().numpy()
        # the residual rows of block i are r @ q_{i+1}, so
        # <q_{i+1}[a]|H q_i[c]> = r[c, a]
        t[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = r.T
        t[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = r.conj()
    return t


def chains(matvec: Callable[[torch.Tensor], torch.Tensor], v0: torch.Tensor,
           m: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Weights and poles (w_n, E_n) of each row of ``v0`` (B, n): the m-step
    tridiagonalization of H from v0[i] / |v0[i]|, truncated where a chain
    breaks down, w_n = |v0[i]|^2 |y_n[0]|^2."""
    norm0 = torch.linalg.norm(v0, dim=1)
    v = v0 / torch.where(norm0 > 0, norm0, 1.0)[:, None]
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros_like(norm0)
    alphas, betas = [], []
    for _ in range(m):
        w = matvec(v)
        alpha = torch.real((v.conj() * w).sum(1))
        w = w - alpha[:, None] * v - beta_prev[:, None] * v_prev
        beta = torch.linalg.norm(w, dim=1)
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, w / torch.where(beta > 0, beta, 1.0)[:, None]
        beta_prev = beta
    a = torch.stack(alphas, 1).double().cpu().numpy()
    bt = torch.stack(betas, 1).double().cpu().numpy()
    n0 = norm0.double().cpu().numpy()
    out = []
    for i in range(v0.shape[0]):
        if n0[i] == 0:
            out.append((np.zeros(0), np.zeros(0)))
            continue
        k = m
        scale = max(1.0, float(np.abs(a[i]).max()))
        for j in range(m - 1):
            if bt[i, j] < 1e-13 * scale:
                k = j + 1
                break
        t = np.diag(a[i, :k]) + np.diag(bt[i, :k - 1], 1) \
            + np.diag(bt[i, :k - 1], -1)
        ev, y = np.linalg.eigh(t)
        out.append((n0[i] ** 2 * np.abs(y[0]) ** 2, ev))
    return out
