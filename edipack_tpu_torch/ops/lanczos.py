"""Krylov eigensolvers on the solve's device, in the working dtype.

Counterpart of the f64/f32 part of edipack_tpu.ops.lanczos (the sweeps run
in the start vector's dtype; the restart bookkeeping on the host):

* :func:`lanczos_sweep` — m-step Lanczos factorization with full (two-pass)
  reorthogonalization against the stored basis; driven by the host-side
  restart / locking / deflation loop of :func:`eigsh_lowest`.
* :func:`lanczos_tridiag` — storage-free tridiagonalization for the
  Green's-function continued fractions (reference lanc_ngfiter moments).
* :func:`batched_eigh` — dense eigh of padded small-sector buckets.

The recurrence scalars stay on the device inside a sweep, so a sweep
enqueues its m steps without a host round trip.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DTYPE

START_SEED = 17     # seed of the start-vector generator (cf. PRNGKey(17))


def _deflate(locked: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v - (locked @ v) @ locked


def _lock(locked_vecs: list, locked_vals: list, vec: torch.Tensor,
          val: float) -> None:
    """Append the Ritz pair (``vec`` deflated against the locked vectors and
    normalized, ``val``) unless nothing of ``vec`` is left."""
    if locked_vecs:
        vec = _deflate(torch.stack(locked_vecs), vec)
    nrm = float(torch.linalg.norm(vec))
    if nrm >= 1e-10:
        locked_vecs.append(vec / nrm)
        locked_vals.append(float(val))


def lanczos_sweep(matvec: Callable, v0: torch.Tensor, m: int,
                  locked: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run an m-step Lanczos factorization from ``v0``.

    Returns (alphas[m], betas[m], V[m+1, dim]): T = tridiag(alphas,
    betas[:-1]), betas[m-1] is the residual coupling. ``locked`` (L, dim)
    converged eigenvectors are projected out of every Krylov vector."""
    dim = v0.shape[0]
    have_locked = locked is not None and locked.shape[0] > 0
    v = v0 / torch.linalg.norm(v0)
    if have_locked:
        v = _deflate(locked, v)
        v = v / torch.linalg.norm(v)
    V = torch.zeros(m + 1, dim, dtype=v0.dtype, device=v0.device)
    V[0] = v
    alphas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    for i in range(m):
        w = matvec(v)
        if have_locked:
            w = _deflate(locked, w)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta_prev * v_prev
        basis = V[:i + 1]
        for _ in range(2):
            w = w - (basis @ w) @ basis
        beta = torch.linalg.norm(w)
        v_next = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0),
                             torch.zeros_like(w))
        V[i + 1] = v_next
        alphas[i] = alpha
        betas[i] = beta
        v_prev, v, beta_prev = v, v_next, beta
    return alphas, betas, V


def lanczos_tridiag(matvec: Callable, v0: torch.Tensor, m: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Storage-free m-step tridiagonalization (GF moments; no reorth).

    Returns (alphas[m], betas[m-1], norm0) where norm0 = |v0|."""
    norm0 = torch.linalg.norm(v0)
    v = v0 / torch.where(norm0 > 0, norm0, 1.0)
    alphas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    for i in range(m):
        w = matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta_prev * v_prev
        beta = torch.linalg.norm(w)
        v_next = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0),
                             torch.zeros_like(w))
        alphas[i] = alpha
        betas[i] = beta
        v_prev, v, beta_prev = v, v_next, beta
    return alphas, betas[:-1], norm0


def _tridiag_eigh(a: np.ndarray, b: np.ndarray, k: int):
    t = np.diag(a[:k])
    if k > 1:
        t += np.diag(b[:k - 1], 1) + np.diag(b[:k - 1], -1)
    return np.linalg.eigh(t)


def eigsh_lowest(matvec: Callable, dim: int, nev: int,
                 dtype: torch.dtype = DTYPE,
                 m: Optional[int] = None, tol: float = 1e-12,
                 max_restarts: int = 60,
                 v0: Optional[np.ndarray | torch.Tensor] = None,
                 stats: Optional[dict] = None
                 ) -> Tuple[np.ndarray, torch.Tensor]:
    """``nev`` lowest eigenpairs by restarted deflated Lanczos.

    Host-driven outer loop, device sweeps on ``matvec.device`` in
    ``dtype``. Returns (evals[nev] numpy, evecs[nev, dim] on the device in
    ``dtype``) sorted ascending. ``v0`` is the start vector (else one is
    drawn in f64 from a CPU generator seeded with 17 and cast, so every
    device and dtype starts from the same vector); operators with
    ``v0_project`` (padded fused layouts) get their padding zeroed in every
    start vector. ``stats`` is filled with ``n_restarts`` and
    ``n_matvecs``."""
    device = matvec.device
    nev = min(nev, dim)
    if dim <= 128:
        # tiny spaces: materialize H by matvec columns and eigh directly
        eye = torch.eye(dim, dtype=dtype, device=device)
        h = torch.stack([matvec(eye[i]) for i in range(dim)], dim=1)
        vals, vecs = np.linalg.eigh(h.cpu().numpy())
        return vals[:nev], torch.as_tensor(np.ascontiguousarray(
            vecs[:, :nev].T), dtype=dtype, device=device)
    if m is None:
        m = min(dim, max(4 * nev + 24, 48))
    m = min(m, dim)
    generator = torch.Generator().manual_seed(START_SEED)

    def random_start():
        v = torch.randn(dim, generator=generator, dtype=torch.float64)
        return v.to(device=device, dtype=dtype)

    project = getattr(matvec, "v0_project", None)
    v0 = random_start() if v0 is None \
        else torch.as_tensor(v0, dtype=dtype, device=device)
    if project is not None:
        v0 = project(v0)
    if stats is None:
        stats = {}
    stats.update(n_restarts=0, n_matvecs=0)

    locked_vecs, locked_vals = [], []
    start = v0
    for restart in range(max_restarts):
        locked = torch.stack(locked_vecs) if locked_vecs else None
        alphas, betas, V = lanczos_sweep(matvec, start, m, locked)
        a = alphas.cpu().numpy()
        b = betas.cpu().numpy()
        stats["n_restarts"] += 1
        stats["n_matvecs"] += m
        # truncate at breakdown (invariant subspace found)
        k_eff = m
        tiny = max(1e-14, 10 * np.finfo(np.float64).eps) \
            * max(1.0, np.abs(a).max())
        for i in range(m - 1):
            if b[i] < tiny:
                k_eff = i + 1
                break
        tvals, tvecs = _tridiag_eigh(a, b, k_eff)
        beta_last = b[k_eff - 1] if k_eff <= m - 1 else b[m - 1]
        want = nev - len(locked_vals)
        n_take = min(want, k_eff)
        resids = np.abs(beta_last * tvecs[-1, :n_take])
        coef = torch.as_tensor(np.ascontiguousarray(tvecs[:, :n_take].T),
                               dtype=dtype, device=device)
        ritz = coef @ V[:k_eff]                          # (n_take, dim)
        V = None
        scale = max(1.0, np.abs(tvals).max())
        j_open = n_take          # the first Ritz pair left unconverged
        for j in range(n_take):
            if resids[j] < tol * scale or k_eff >= dim - len(locked_vals):
                _lock(locked_vecs, locked_vals, ritz[j], tvals[j])
            else:
                j_open = j
                break
        if len(locked_vals) >= nev:
            break
        # restart from the first unconverged Ritz vector
        if j_open < n_take:
            start = ritz[j_open]
        else:
            start = random_start()
            if project is not None:
                start = project(start)
        nrm = torch.linalg.norm(start)
        start = start / nrm if float(nrm) > 1e-12 else v0
    else:
        # at the restart cap, accept the last sweep's unconverged Ritz pairs
        # in order, each deflated against the locked vectors and taken once
        for j in range(j_open, n_take):
            if len(locked_vals) >= nev:
                break
            _lock(locked_vecs, locked_vals, ritz[j], tvals[j])

    order = np.argsort(locked_vals[:nev])
    vals = np.asarray(locked_vals)[order]
    vecs = torch.stack([locked_vecs[i] for i in order])
    return vals, vecs


def batched_eigh(mats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched dense diagonalization of padded small-sector Hamiltonians
    (reference LAPACK path, ED_DIAG_NORMAL.f90:225-250, one batch per
    bucket)."""
    return torch.linalg.eigh(mats)
