"""χ² bath fitting (normal, superc and nonsu2 modes).

Parity target: reference ED_FIT/ (ED_BATH_FIT.f90:29-55 interface;
per-(bath_type×ed_mode) χ² and gradients, e.g. ED_FIT_NORMAL.f90:709-761);
counterpart of edipack_tpu.bath.fit. The Anderson function Δ(iω;p) /
G0(iω;p) is written in PyTorch over the *packed bath vector*, the gradient
comes from ``torch.autograd`` (in place of the reference's hand-coded
analytic gradients), and scipy's CG / BFGS / L-BFGS-B minimizes on the host.

Where it runs: the χ² is built from float64 / complex128 tensors on the
host CPU, whatever device the solve runs on. It is norb² × lfit work driven
by a host-side optimizer that reads a scalar every iteration; on a card
each of the cg_niter × 5 evaluations would pay a launch-and-copy round trip
for work the host does in microseconds. edipack_tpu pins its fit to the
host backend for the same reason, and the reference fits on the host.

Fit targets (cg_scheme): 'delta' fits Δ(iω), 'weiss' fits G0and(iω).
Weights (cg_weight): 1, 1/n, or 1/ω_n; power cg_pow; first cfg.lfit
Matsubara frequencies. superc fits (Δ, FΔ) or (G0, F0) jointly (the Nambu
Weiss field); nonsu2 fits the full spin-block Δ or G0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.optimize
import torch

from ..config import EDConfig
from .replica import ReplicaBasis

FIT_DEVICE = torch.device("cpu")
RDTYPE, CDTYPE = torch.float64, torch.complex128


def _eye(n: int, dtype=RDTYPE) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=FIT_DEVICE)


# ---------------------------------------------------------------------------
# Anderson functions from the packed bath vector (normal mode)
# ---------------------------------------------------------------------------


def _unpack_normal(p: torch.Tensor, cfg: EDConfig):
    """packed (normal/hybrid, ed_mode normal) -> (e, v) tensors."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        e = p[: ns * no * nb].reshape(ns, no, nb)
        v = p[ns * no * nb: 2 * ns * no * nb].reshape(ns, no, nb)
    else:  # hybrid
        e = p[: ns * nb].reshape(ns, 1, nb)
        v = p[ns * nb: ns * nb + ns * no * nb].reshape(ns, no, nb)
    return e, v


def delta_normal(p: torch.Tensor, z: torch.Tensor, cfg: EDConfig,
                 ispin: int) -> torch.Tensor:
    """Δ^s_ab(z): (Norb, Norb, Lz) for the requested spin (0-based)."""
    e, v = _unpack_normal(p, cfg)
    if cfg.bath_type == "normal":
        # diagonal: Σ_k v²/(z - e)
        d = torch.sum(v[ispin, :, :, None] ** 2
                      / (z[None, None, :] - e[ispin, :, :, None]), dim=1)
        return torch.einsum("al,ab->abl", d, _eye(cfg.norb, d.dtype))
    return torch.sum(v[ispin, :, None, :, None] * v[ispin, None, :, :, None]
                     / (z[None, None, None, :]
                        - e[ispin, 0, None, None, :, None]), dim=2)


def delta_replica(p: torch.Tensor, z: torch.Tensor, cfg: EDConfig,
                  basis: ReplicaBasis, ispin: int) -> torch.Tensor:
    """Replica/general Δ^s(z) via (Norb,Norb) inversion per z per replica."""
    nb, no, ns = cfg.nbath, cfg.norb, cfg.nspin
    nsym = basis.nsym
    ops = torch.as_tensor(np.real(basis.ops[:, ispin, ispin]), dtype=RDTYPE,
                          device=FIT_DEVICE)               # (Nsym,No,No)
    pos = 1
    out = torch.zeros((no, no, z.shape[0]), dtype=z.dtype, device=FIT_DEVICE)
    for _ in range(nb):
        if cfg.bath_type == "replica":
            vk = p[pos] * torch.ones(no, dtype=RDTYPE, device=FIT_DEVICE)
            pos += 1
        else:
            vk = p[pos: pos + ns * no].reshape(ns, no)[ispin]
            pos += ns * no
        lam = p[pos: pos + nsym]
        pos += nsym
        hk = torch.einsum("s,sab->ab", lam, ops)
        zi = z[:, None, None] * _eye(no, z.dtype)[None] - hk[None]
        g = torch.linalg.inv(zi)  # (Lz, No, No)
        vc = vk.to(z.dtype)
        out = out + torch.einsum("a,lab,b->abl", vc, g, vc)
    return out


def weiss_from_delta(delta: torch.Tensor, z: torch.Tensor,
                     hloc_s: torch.Tensor, cfg: EDConfig) -> torch.Tensor:
    """G0(z) = [(z+μ) - Hloc - Δ(z)]⁻¹ per frequency (Norb matrix)."""
    no = cfg.norb
    m = (z[:, None, None] + cfg.xmu) * _eye(no, z.dtype)[None] \
        - hloc_s[None] - torch.movedim(delta, -1, 0)
    return torch.movedim(torch.linalg.inv(m), 0, -1)


# ---------------------------------------------------------------------------
# superc and nonsu2 Anderson functions
# ---------------------------------------------------------------------------


def _unpack_superc(p: torch.Tensor, cfg: EDConfig):
    """packed superc bath -> (e, d, v)."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        n = ns * no * nb
        return (p[:n].reshape(ns, no, nb), p[n:2 * n].reshape(ns, no, nb),
                p[2 * n:3 * n].reshape(ns, no, nb))
    ne = ns * nb
    return (p[:ne].reshape(ns, 1, nb), p[ne:2 * ne].reshape(ns, 1, nb),
            p[2 * ne:2 * ne + ns * no * nb].reshape(ns, no, nb))


def delta_superc(p: torch.Tensor, z: torch.Tensor, cfg: EDConfig):
    """(Δ, FΔ) on the Matsubara-like grid (reference delta/fdelta_normal
    superc branches): Δ = -Σ v²(z+e)/(|Im z|²+e²+d²), FΔ = Σ v²d/(...)."""
    e, d, v = _unpack_superc(p, cfg)
    den_z = z.imag ** 2
    if cfg.bath_type == "normal":
        den = den_z[None, None, :] + (e[0, :, :, None] ** 2
                                      + d[0, :, :, None] ** 2)
        dd = -torch.sum(v[0, :, :, None] ** 2
                        * (z[None, None, :] + e[0, :, :, None]) / den, dim=1)
        fd = torch.sum(v[0, :, :, None] ** 2 * d[0, :, :, None] / den, dim=1)
        eye = _eye(cfg.norb)
        return (torch.einsum("al,ab->abl", dd, eye.to(dd.dtype)),
                torch.einsum("al,ab->abl", fd, eye).to(dd.dtype))
    den = den_z[None, :] + e[0, 0, :, None] ** 2 + d[0, 0, :, None] ** 2
    vv = v[0, :, None, :, None] * v[0, None, :, :, None]     # (No,No,Nb,L)
    dd = -torch.sum(vv * (z[None, None, None, :]
                          + e[0, 0, None, None, :, None])
                    / den[None, None], dim=2)
    fd = torch.sum(vv * d[0, 0, None, None, :, None] / den[None, None], dim=2)
    return dd, fd.to(dd.dtype)


def _replica_items(p: torch.Tensor, cfg: EDConfig, basis: ReplicaBasis):
    """Iterate the packed replica/general bath: yields (vk (Nspin*Norb,),
    lam (Nsym,)) per replica, skipping the leading Nsym slot."""
    nb, no, ns = cfg.nbath, cfg.norb, cfg.nspin
    nsym = basis.nsym
    pos = 1
    for _ in range(nb):
        if cfg.bath_type == "replica":
            vk = p[pos] * torch.ones(ns * no, dtype=RDTYPE, device=FIT_DEVICE)
            pos += 1
        else:
            vk = p[pos: pos + ns * no]
            pos += ns * no
        lam = p[pos: pos + nsym]
        pos += nsym
        yield vk.to(CDTYPE), lam.to(CDTYPE)


def delta_replica_superc(p: torch.Tensor, z: torch.Tensor, cfg: EDConfig,
                         basis: ReplicaBasis):
    """Replica/general superc (Δ, FΔ) via the Nambu 2Norb×2Norb replica
    inversion (bath.functions._delta_replica_superc)."""
    no = cfg.norb
    ops = torch.as_tensor(basis.ops, dtype=CDTYPE, device=FIT_DEVICE)
    dd = torch.zeros((no, no, z.shape[0]), dtype=CDTYPE, device=FIT_DEVICE)
    fd = torch.zeros_like(dd)
    eye2 = _eye(2 * no, CDTYPE)
    for vk, lam in _replica_items(p, cfg, basis):
        hk = torch.einsum("s,sab->ab", lam, ops[:, 0, 0])
        dk = torch.einsum("s,sab->ab", lam, ops[:, 0, 1])
        hnam = torch.cat([torch.cat([hk, dk], 1),
                          torch.cat([dk.T.conj(), -hk.T], 1)], 0)
        vnam = torch.cat([vk[:no], -vk[:no]])
        g = torch.linalg.inv(z[:, None, None] * eye2[None] - hnam[None])
        d = vnam[None, :, None] * g * vnam[None, None, :]
        dd = dd + torch.movedim(d[:, :no, :no], 0, -1)
        fd = fd + torch.movedim(d[:, :no, no:], 0, -1)
    return dd, fd


def delta_replica_nonsu2(p: torch.Tensor, z: torch.Tensor, cfg: EDConfig,
                         basis: ReplicaBasis) -> torch.Tensor:
    """Replica/general nonsu2 Δ^{ss'}(z) = Σ_k V (z - H_k)⁻¹ V with the full
    spin-space replica Hamiltonians (bath.functions.delta_bath replica)."""
    ns, no = cfg.nspin, cfg.norb
    nso = ns * no
    ops = torch.as_tensor(basis.ops, dtype=CDTYPE, device=FIT_DEVICE)
    ops = ops.permute(0, 1, 3, 2, 4).reshape(-1, nso, nso)
    out = torch.zeros((ns, ns, no, no, z.shape[0]), dtype=CDTYPE,
                      device=FIT_DEVICE)
    eye = _eye(nso, CDTYPE)
    for vk, lam in _replica_items(p, cfg, basis):
        hk = torch.einsum("s,sij->ij", lam, ops)
        g = torch.linalg.inv(z[:, None, None] * eye[None] - hk[None])
        d = vk[None, :, None] * g * vk[None, None, :]
        out = out + d.reshape(-1, ns, no, ns, no).permute(1, 3, 2, 4, 0)
    return out


def _unpack_nonsu2(p: torch.Tensor, cfg: EDConfig):
    """packed nonsu2 bath -> (e, v, u)."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        n = ns * no * nb
        return (p[:n].reshape(ns, no, nb), p[n:2 * n].reshape(ns, no, nb),
                p[2 * n:3 * n].reshape(ns, no, nb))
    ne = ns * nb
    nv = ns * no * nb
    return (p[:ne].reshape(ns, 1, nb), p[ne:ne + nv].reshape(ns, no, nb),
            p[ne + nv:ne + 2 * nv].reshape(ns, no, nb))


def delta_nonsu2(p: torch.Tensor, z: torch.Tensor,
                 cfg: EDConfig) -> torch.Tensor:
    """Δ^{ss'}_ab(z) with spin-flip amplitudes (reference delta_normal nonsu2
    branch: W(s,h)=v if h==s else u; Δ^{ss'} = Σ_h W(s,h)W(s',h)/(z-e_h))."""
    e, v, u = _unpack_nonsu2(p, cfg)
    ns, no = cfg.nspin, cfg.norb
    w = torch.stack([torch.stack([v[0], u[0]]),
                     torch.stack([u[ns - 1], v[ns - 1]])]).to(CDTYPE)
    if cfg.bath_type == "normal":
        eh = torch.stack([e[0], e[ns - 1]])             # (h, No, Nb)
        dd = torch.einsum("shak,thak,hakl->stal", w, w,
                          1.0 / (z[None, None, None, :] - eh[..., None]))
        return torch.einsum("stal,ab->stabl", dd, _eye(no, CDTYPE))
    eh = torch.stack([e[0, 0], e[ns - 1, 0]])           # (h, Nb)
    return torch.einsum("shak,thbk,hkl->stabl", w, w,
                        1.0 / (z[None, None, :] - eh[..., None]))


def _fit_indices(cfg: EDConfig, nparam: int, s: int, iorb: Optional[int],
                 is_replica: bool) -> np.ndarray:
    """The packed entries a fit of spin ``s`` (and orbital ``iorb``)
    moves: every entry in superc and nonsu2."""
    if is_replica:
        return np.arange(1, nparam)
    if cfg.ed_mode != "normal":
        return np.arange(nparam)
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        if iorb is not None:
            # single-orbital component fit (reference ED_BATH_FIT.f90:112-113):
            # only orbital iorb's (e, v) move
            io = iorb - 1
            idx_e = s * no * nb + io * nb + np.arange(nb)
            idx_v = ns * no * nb + s * no * nb + io * nb + np.arange(nb)
        else:
            idx_e = np.arange(no * nb) + s * no * nb
            idx_v = ns * no * nb + s * no * nb + np.arange(no * nb)
    else:
        idx_e = s * nb + np.arange(nb)
        idx_v = ns * nb + s * no * nb + np.arange(no * nb)
    return np.concatenate([idx_e, idx_v])


def chi2_function(cfg: EDConfig, func, bath_array: np.ndarray,
                  ispin: int = 1, iorb: Optional[int] = None,
                  basis: Optional[ReplicaBasis] = None,
                  hloc: Optional[np.ndarray] = None):
    """The χ² of a fit as a function of the moved entries.

    ``func``: normal mode (Norb,Norb,L) or (Nspin,Nspin,Norb,Norb,L);
    superc the (normal, anomalous) pair, stacked or as a tuple; nonsu2
    (Nspin,Nspin,Norb,Norb,L). Returns (chi2, p_full, fit_idx):
    ``chi2(p_fit)`` maps a float64 tensor of the entries ``fit_idx`` of the
    packed bath ``p_full`` to a scalar tensor that autograd
    differentiates."""
    s = ispin - 1
    mode = cfg.ed_mode
    if isinstance(func, (tuple, list)):
        func = np.stack([np.asarray(f) for f in func])
    func = np.asarray(func)
    if mode == "normal":
        if func.ndim == 5:
            func = func[s, s]
        elif func.ndim == 1:
            func = func[None, None, :]
    elif mode == "superc" and func.ndim == 6:   # (2, Nspin, Nspin, No, No, L)
        func = func[:, 0, 0]
    nfit = min(cfg.lfit, func.shape[-1])
    target = torch.as_tensor(func[..., :nfit], dtype=CDTYPE,
                             device=FIT_DEVICE)
    wn = (2 * np.arange(nfit) + 1) * np.pi / cfg.beta
    z = torch.as_tensor(1j * wn, dtype=CDTYPE, device=FIT_DEVICE)
    if cfg.cg_weight == 1:
        wts = np.ones(nfit)
    elif cfg.cg_weight == 2:
        wts = 1.0 / np.arange(1, nfit + 1)
    else:
        wts = 1.0 / wn
    wts = torch.as_tensor(wts, dtype=RDTYPE, device=FIT_DEVICE)
    if hloc is None:
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    hloc_s = torch.as_tensor(np.real(hloc[s, s]), dtype=RDTYPE,
                             device=FIT_DEVICE)

    is_replica = cfg.bath_type in ("replica", "general")
    p_full = torch.as_tensor(np.asarray(bath_array, float), dtype=RDTYPE,
                             device=FIT_DEVICE)
    fit_idx = torch.as_tensor(
        _fit_indices(cfg, p_full.shape[0], s, iorb, is_replica),
        dtype=torch.int64, device=FIT_DEVICE)
    no = cfg.norb
    # masked components: the orbital-diagonal of a normal bath, the one
    # orbital of a single-orbital normal-mode fit
    mask = None
    if cfg.bath_type == "normal":
        mask = _eye(no)
    if iorb is not None and mode == "normal":
        single = torch.zeros((no, no), dtype=RDTYPE, device=FIT_DEVICE)
        single[iorb - 1, iorb - 1] = 1.0
        mask = single if mask is None else mask * single
    eye_c = _eye(no, CDTYPE)

    def reduce_chi2(diff):
        """cg_norm reduction (reference ED_FIT_*: 'elemental' sums
        |diff_ab|^pow per component; 'frobenius' takes the per-frequency
        matrix Frobenius norm^pow, chi2_delta_general_frobenius)."""
        if cfg.cg_norm == "frobenius":
            fro = torch.sqrt(torch.sum(torch.abs(diff) ** 2,
                                       dim=tuple(range(diff.ndim - 1))))
            return torch.sum(wts * fro ** cfg.cg_pow) / nfit \
                / (cfg.nspin * cfg.norb)
        return torch.sum(wts * torch.abs(diff) ** cfg.cg_pow) / nfit

    def model_normal(p):
        if is_replica:
            d = delta_replica(p, z, cfg, basis, s)
        else:
            d = delta_normal(p, z, cfg, s)
        return weiss_from_delta(d, z, hloc_s, cfg) \
            if cfg.cg_scheme == "weiss" else d

    def model_superc(p):
        if is_replica:
            dd, fd = delta_replica_superc(p, z, cfg, basis)
        else:
            dd, fd = delta_superc(p, z, cfg)
        if cfg.cg_scheme != "weiss":
            return torch.stack([dd, fd])
        a11 = (z[:, None, None] + cfg.xmu) * eye_c[None] \
            - hloc_s[None] - torch.movedim(dd, -1, 0)
        a12 = -torch.movedim(fd, -1, 0)
        m = torch.cat([torch.cat([a11, a12], 2),
                       torch.cat([a12.transpose(1, 2).conj(), -a11.conj()],
                                 2)], 1)
        gi = torch.linalg.inv(m)
        return torch.stack([torch.movedim(gi[:, :no, :no], 0, -1),
                            torch.movedim(gi[:, :no, no:], 0, -1)])

    hloc_full = torch.as_tensor(np.asarray(hloc, complex), dtype=CDTYPE,
                                device=FIT_DEVICE)

    def model_nonsu2(p):
        if is_replica:
            dd = delta_replica_nonsu2(p, z, cfg, basis)
        else:
            dd = delta_nonsu2(p, z, cfg)               # (s,s',a,b,L)
        if cfg.cg_scheme != "weiss":
            return dd
        ns_ = cfg.nspin
        nso = ns_ * no
        hmat = hloc_full.permute(0, 2, 1, 3).reshape(nso, nso)
        dmat = dd.permute(4, 0, 2, 1, 3).reshape(-1, nso, nso)
        m = (z[:, None, None] + cfg.xmu) * _eye(nso, CDTYPE)[None] \
            - hmat[None] - dmat
        gi = torch.linalg.inv(m)
        return gi.reshape(-1, ns_, no, ns_, no).permute(1, 3, 2, 4, 0)

    model = {"normal": model_normal, "superc": model_superc,
             "nonsu2": model_nonsu2}[mode]

    def chi2(p_fit: torch.Tensor) -> torch.Tensor:
        # out of place, so that autograd sees the scatter
        p = p_full.index_copy(0, fit_idx, p_fit)
        diff = model(p) - target
        if mask is not None:
            # masked components are exactly 0; abs' gradient there is 0
            diff = diff * mask[..., None]
        return reduce_chi2(diff)

    return chi2, p_full, fit_idx


def value_and_grad(chi2):
    """numpy x -> (χ², ∇χ²) through torch.autograd, on the host CPU."""
    def fun(x):
        p = torch.tensor(np.asarray(x, float), dtype=RDTYPE,
                         device=FIT_DEVICE, requires_grad=True)
        val = chi2(p)
        (grad,) = torch.autograd.grad(val, p)
        return float(val.detach()), grad.numpy().astype(float)
    return fun


def _minimize_options(cfg: EDConfig):
    """cg_method 0 -> CG (reference fmin_cg); 1 -> the "minimize" backend,
    where cg_minimize_ver picks the older Krauth-style quasi-Newton (BFGS,
    dense Hessian as the older routine builds) vs the newer limited-memory
    variant (reference ED_INPUT_VARS.f90:744)."""
    if cfg.cg_method == 0:
        method = "CG"
    else:
        method = "BFGS" if cfg.cg_minimize_ver else "L-BFGS-B"
    if method in ("CG", "BFGS"):
        return method, {"maxiter": cfg.cg_niter, "gtol": cfg.cg_ftol * 1e-2}
    # cg_stop (reference ED_FIT_COMMON stopping conditions): 0 = both C1
    # (function change) and C2 (argument change), 1 = C1 only, 2 = C2 only,
    # mapped onto scipy L-BFGS-B's ftol/gtol pair
    opts = {"maxiter": cfg.cg_niter}
    if cfg.cg_stop in (0, 1):
        opts["ftol"] = cfg.cg_ftol
    if cfg.cg_stop in (0, 2):
        opts["gtol"] = cfg.cg_ftol * 1e-2
    if cfg.cg_stop == 2:
        opts["ftol"] = 1e-30   # disable C1, stop on gradient/step only
    return method, opts


def chi2_fitgf(cfg: EDConfig, func: np.ndarray, bath_array: np.ndarray,
               ispin: int = 1, iorb: Optional[int] = None,
               basis: Optional[ReplicaBasis] = None,
               hloc: Optional[np.ndarray] = None) -> np.ndarray:
    """Fit the bath to ``func`` = Weiss field or Δ on Matsubara frequencies.

    ``func``: (Norb,Norb,Lmats) or (Nspin,Nspin,Norb,Norb,Lmats); returns the
    updated packed bath array (the reference overwrites the user bath)."""
    chi2, p_full, fit_idx = chi2_function(cfg, func, bath_array, ispin,
                                          iorb, basis, hloc)
    fun = value_and_grad(chi2)
    idx = fit_idx.numpy()
    x0 = p_full.numpy()[idx]
    method, opts = _minimize_options(cfg)
    # multi-start: the χ² landscape has spurious basins (a bath pole
    # escaping to large |e| with v->0); a few perturbed restarts recover the
    # global basin. The first start is always the caller's bath (warm start
    # across DMFT iterations); numpy's generator keeps the starts those of
    # edipack_tpu.
    rng = np.random.default_rng(12345)
    starts = [x0]
    for _ in range(4):
        starts.append(x0 + rng.normal(scale=0.3, size=x0.shape)
                      * np.maximum(1.0, np.abs(x0)))
    best = None
    for xs in starts:
        res = scipy.optimize.minimize(fun, xs, jac=True, method=method,
                                      options=opts)
        if best is None or res.fun < best.fun:
            best = res
        if best.fun < 1e-12:
            break
    out = p_full.numpy().copy()
    out[idx] = best.x
    return out
