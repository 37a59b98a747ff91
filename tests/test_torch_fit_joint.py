"""The superc and nonsu2 χ² bath fits of edipack_tpu_torch (bath/fit.py)
against edipack_tpu's (edipack_tpu/bath/fit.py): the (Δ, FΔ) and Δ^{ss'}
model functions, the χ² and its autograd gradient against
jax.value_and_grad, and whole fits through scipy, on the CPU at small
sizes (mirrors tests/test_fit_joint.py and tests/test_torch_fit.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edipack_tpu.bath.fit as jfit
from edipack_tpu.bath.dmft_bath import array_to_bath as j_array_to_bath
from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.bath.functions import delta_bath as j_delta_bath
from edipack_tpu.bath.functions import fdelta_bath as j_fdelta_bath
from edipack_tpu.bath.replica import make_basis as j_make_basis
from edipack_tpu.config import default_config as j_config

import edipack_tpu_torch.bath.fit as tfit
from edipack_tpu_torch.bath.replica import make_basis
from edipack_tpu_torch.config import default_config

torch.set_num_threads(1)
MODEL_TOL = 1e-13        # Δ, FΔ against the JAX functions, relative
GRAD_RTOL = 1e-10        # χ² and its gradient against jax.value_and_grad
FIT_FACTOR = 10.0        # whole fits: within 10× JAX's own spread under a
#                          1e-12 change of the target (test_torch_fit.py)


def _configs(**kw):
    return j_config(**kw), default_config(**kw)


def _nambu_ops(norb=2):
    """Nambu replica basis (h, -hᵀ), same-orbital and cross pairing
    (tests/test_fit_joint.py)."""
    o1 = np.zeros((2, 2, norb, norb), complex)
    o1[0, 0] = np.diag(np.linspace(1.0, -1.0, norb))
    o1[1, 1] = -o1[0, 0].T
    o2 = np.zeros((2, 2, norb, norb), complex)
    o2[0, 1] = o2[1, 0] = np.eye(norb)
    o3 = np.zeros((2, 2, norb, norb), complex)
    o3[0, 1] = o3[1, 0] = np.ones((norb, norb)) - np.eye(norb)
    return np.stack([o1, o2, o3])


def _spin_ops(norb=2):
    """nonsu2 replica basis: the identity and a spin-mixing SOC-like
    Hermitian matrix."""
    eye = np.zeros((2, 2, norb, norb), complex)
    eye[0, 0] = eye[1, 1] = np.eye(norb)
    soc = np.zeros((2, 2, norb, norb), complex)
    soc[0, 1] = 0.3j * np.eye(norb)
    soc[1, 0] = -0.3j * np.eye(norb)
    soc[0, 0] = np.diag(np.linspace(0.2, -0.2, norb))
    soc[1, 1] = -soc[0, 0]
    return np.stack([eye, soc])


def _bases(mode, nbath, rng):
    ops = _nambu_ops() if mode == "superc" else _spin_ops()
    lam = rng.uniform(-0.6, 0.6, size=(nbath, ops.shape[0]))
    return (j_make_basis(ops, lam, nbath=nbath),
            make_basis(ops, lam, nbath=nbath))


def _random_bath(cfg, rng, basis=None):
    """A random packed bath of cfg's layout: levels in [-1, 1],
    hybridizations and pairings 0.1-0.6."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if basis is not None:
        per = 1 if cfg.bath_type == "replica" else ns * no
        out = [float(basis.nsym)]
        for _ in range(nb):
            out += list(rng.uniform(0.2, 0.6, per))
            out += list(rng.uniform(-1, 1, basis.nsym))
        return np.asarray(out)
    ne = ns * no * nb if cfg.bath_type == "normal" else ns * nb
    if cfg.ed_mode == "superc":       # e, d, v
        return np.concatenate([rng.uniform(-1, 1, ne),
                               rng.uniform(0.1, 0.4, ne),
                               rng.uniform(0.2, 0.6, ns * no * nb)])
    return np.concatenate([rng.uniform(-1, 1, ne),        # e, v, u
                           rng.uniform(0.2, 0.6, ns * no * nb),
                           rng.uniform(0.05, 0.3, ns * no * nb)])


MODES = {
    "superc-normal": dict(ed_mode="superc", bath_type="normal"),
    "superc-hybrid": dict(ed_mode="superc", bath_type="hybrid"),
    "superc-replica": dict(ed_mode="superc", bath_type="replica"),
    "superc-general": dict(ed_mode="superc", bath_type="general"),
    "nonsu2-normal": dict(ed_mode="nonsu2", bath_type="normal", nspin=2),
    "nonsu2-hybrid": dict(ed_mode="nonsu2", bath_type="hybrid", nspin=2),
    "nonsu2-replica": dict(ed_mode="nonsu2", bath_type="replica", nspin=2),
    "nonsu2-general": dict(ed_mode="nonsu2", bath_type="general", nspin=2),
}


def _setup(name, nbath=2, **kw):
    mode = dict(MODES[name])
    jcfg, cfg = _configs(norb=2, nbath=nbath, xmu=0.2, beta=40.0, **mode,
                         **kw)
    jb = tb = None
    if cfg.bath_type in ("replica", "general"):
        jb, tb = _bases(cfg.ed_mode, nbath, np.random.default_rng(5))
    return jcfg, cfg, jb, tb


@pytest.mark.parametrize("name", list(MODES))
def test_joint_models(name):
    """(Δ, FΔ) / Δ^{ss'} of a random packed bath against
    _delta_superc_jax, _delta_replica_superc_jax, _delta_nonsu2_jax and
    _delta_replica_nonsu2_jax."""
    jcfg, cfg, jb, tb = _setup(name)
    p = _random_bath(cfg, np.random.default_rng(3), tb)
    z = 1j * (2 * np.arange(64) + 1) * np.pi / cfg.beta
    jp, jz = jnp.asarray(p), jnp.asarray(z)
    tp, tz = torch.as_tensor(p), torch.as_tensor(z)
    if cfg.ed_mode == "superc":
        if tb is None:
            want = jfit._delta_superc_jax(jp, jz, jcfg)
            got = tfit.delta_superc(tp, tz, cfg)
        else:
            want = jfit._delta_replica_superc_jax(jp, jz, jcfg, jb)
            got = tfit.delta_replica_superc(tp, tz, cfg, tb)
        want = np.stack([np.asarray(w) for w in want])
        got = torch.stack(got).numpy()
    else:
        if tb is None:
            want = np.asarray(jfit._delta_nonsu2_jax(jp, jz, jcfg))
            got = tfit.delta_nonsu2(tp, tz, cfg).numpy()
        else:
            want = np.asarray(jfit._delta_replica_nonsu2_jax(jp, jz, jcfg,
                                                             jb))
            got = tfit.delta_replica_nonsu2(tp, tz, cfg, tb).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MODEL_TOL * np.abs(want).max()


def _jax_chi2(jcfg, target, p_full, fit_idx, basis, hloc):
    """The superc / nonsu2 χ² of edipack_tpu.bath.fit.chi2_fitgf, composed
    from its model functions."""
    nfit = min(jcfg.lfit, target.shape[-1])
    tg = jnp.asarray(target[..., :nfit])
    wn = (2 * np.arange(nfit) + 1) * np.pi / jcfg.beta
    z = jnp.asarray(1j * wn)
    wts = jnp.asarray({1: np.ones(nfit), 2: 1.0 / np.arange(1, nfit + 1),
                       3: 1.0 / wn}[jcfg.cg_weight])
    no, ns = jcfg.norb, jcfg.nspin
    p_full = jnp.asarray(p_full)
    idx = jnp.asarray(fit_idx)
    rep = basis is not None

    def model(p):
        if jcfg.ed_mode == "superc":
            dd, fd = (jfit._delta_replica_superc_jax(p, z, jcfg, basis)
                      if rep else jfit._delta_superc_jax(p, z, jcfg))
            if jcfg.cg_scheme != "weiss":
                return jnp.stack([dd, fd])
            hs = jnp.asarray(np.real(hloc[0, 0]))
            a11 = (z[:, None, None] + jcfg.xmu) * jnp.eye(no)[None] \
                - hs[None] - jnp.moveaxis(dd, -1, 0)
            a12 = -jnp.moveaxis(fd, -1, 0)
            m = jnp.block([[a11, a12], [jnp.conj(jnp.swapaxes(a12, 1, 2)),
                                        -jnp.conj(a11)]])
            gi = jnp.linalg.inv(m)
            return jnp.stack([jnp.moveaxis(gi[:, :no, :no], 0, -1),
                              jnp.moveaxis(gi[:, :no, no:], 0, -1)])
        dd = (jfit._delta_replica_nonsu2_jax(p, z, jcfg, basis) if rep
              else jfit._delta_nonsu2_jax(p, z, jcfg))
        if jcfg.cg_scheme != "weiss":
            return dd
        nso = ns * no
        hmat = jnp.asarray(hloc).transpose(0, 2, 1, 3).reshape(nso, nso)
        dmat = jnp.moveaxis(dd, -1, 0).transpose(0, 1, 3, 2, 4) \
            .reshape(-1, nso, nso)
        m = (z[:, None, None] + jcfg.xmu) * jnp.eye(nso)[None] \
            - hmat[None] - dmat
        gi = jnp.linalg.inv(m)
        return gi.reshape(-1, ns, no, ns, no).transpose(1, 3, 2, 4, 0)

    def chi2(p_fit):
        diff = model(p_full.at[idx].set(p_fit)) - tg
        if jcfg.bath_type == "normal":
            diff = diff * jnp.eye(no)[..., None]
        if jcfg.cg_norm == "frobenius":
            fro = jnp.sqrt(jnp.sum(jnp.abs(diff) ** 2,
                                   axis=tuple(range(diff.ndim - 1))))
            return jnp.sum(wts * fro ** jcfg.cg_pow) / nfit / (ns * no)
        return jnp.sum(wts * jnp.abs(diff) ** jcfg.cg_pow) / nfit

    return jax.jit(jax.value_and_grad(chi2))


GRAD_CASES = {
    "superc-normal-delta": dict(mode="superc-normal", cg_scheme="delta"),
    "superc-normal-weiss-frobenius": dict(mode="superc-normal",
                                          cg_scheme="weiss",
                                          cg_norm="frobenius"),
    "superc-hybrid-weiss-w3": dict(mode="superc-hybrid", cg_scheme="weiss",
                                   cg_weight=3),
    "superc-replica-delta-pow1": dict(mode="superc-replica",
                                      cg_scheme="delta", cg_pow=1),
    "superc-general-weiss": dict(mode="superc-general", cg_scheme="weiss"),
    "nonsu2-normal-weiss": dict(mode="nonsu2-normal", cg_scheme="weiss"),
    "nonsu2-hybrid-delta-w2": dict(mode="nonsu2-hybrid", cg_scheme="delta",
                                   cg_weight=2),
    "nonsu2-replica-weiss-frobenius": dict(mode="nonsu2-replica",
                                           cg_scheme="weiss",
                                           cg_norm="frobenius"),
    "nonsu2-general-delta": dict(mode="nonsu2-general", cg_scheme="delta"),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_chi2_gradient(case):
    """The port's χ² and its torch.autograd gradient at a random bath
    against jax.value_and_grad of the same χ²."""
    kw = dict(GRAD_CASES[case])
    jcfg, cfg, jb, tb = _setup(kw.pop("mode"), lfit=100, **kw)
    rng = np.random.default_rng(7)
    ns, no = cfg.nspin, cfg.norb
    shape = (2, no, no, 120) if cfg.ed_mode == "superc" \
        else (ns, ns, no, no, 120)
    target = 0.1 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    hloc = np.zeros((ns, ns, no, no), complex)
    hloc[0, 0] = [[0.1, 0.03], [0.03, -0.2]]
    hloc[-1, -1] = hloc[0, 0]
    if cfg.ed_mode == "nonsu2":
        hloc[0, 1] = 0.05j * np.eye(no)
        hloc[1, 0] = -0.05j * np.eye(no)
    p0 = _random_bath(cfg, np.random.default_rng(11), tb)
    chi2, p_full, fit_idx = tfit.chi2_function(cfg, target, p0, 1, None, tb,
                                               hloc)
    x = p_full.numpy()[fit_idx.numpy()] + rng.normal(scale=0.05,
                                                     size=len(fit_idx))
    val, grad = tfit.value_and_grad(chi2)(x)
    jval, jgrad = _jax_chi2(jcfg, target, p0, fit_idx.numpy(), jb,
                            hloc)(jnp.asarray(x))
    jgrad = np.asarray(jgrad)
    assert np.all(np.isfinite(grad))
    assert abs(val - float(jval)) <= GRAD_RTOL * abs(float(jval))
    assert np.abs(grad - jgrad).max() <= GRAD_RTOL * np.abs(jgrad).max()


def _superc_target(jcfg):
    truth = j_init_bath(jcfg)
    truth.e[0, 0] = [-0.6, 0.05, 0.8]
    truth.d[0, 0] = [0.3, 0.25, 0.2]
    truth.v[0, 0] = [0.4, 0.3, 0.5]
    z = 1j * (2 * np.arange(jcfg.lfit) + 1) * np.pi / jcfg.beta
    return np.stack([j_delta_bath(jcfg, truth, z)[0, 0],
                     j_fdelta_bath(jcfg, truth, z)[0, 0]])


def _nonsu2_target(jcfg):
    truth = j_init_bath(jcfg)
    truth.e[:, 0] = [[-0.5, 0.7], [-0.5, 0.7]]
    truth.v[:, 0] = [[0.45, 0.35], [0.45, 0.35]]
    truth.u[:, 0] = [[0.2, 0.15], [0.2, 0.15]]
    z = 1j * (2 * np.arange(jcfg.lfit) + 1) * np.pi / jcfg.beta
    return j_delta_bath(jcfg, truth, z)


def _model_on_window(jcfg, arr):
    z = 1j * (2 * np.arange(jcfg.lfit) + 1) * np.pi / jcfg.beta
    b = j_array_to_bath(arr, jcfg)
    if jcfg.ed_mode == "superc":
        return np.stack([j_delta_bath(jcfg, b, z), j_fdelta_bath(jcfg, b, z)])
    return j_delta_bath(jcfg, b, z)


FIT_CASES = {
    "superc-lbfgsb": dict(norb=1, nbath=3, nspin=1, ed_mode="superc",
                          beta=50.0, lfit=120, cg_method=1),
    "superc-cg": dict(norb=1, nbath=3, nspin=1, ed_mode="superc",
                      beta=50.0, lfit=120, cg_ftol=1e-3),
    "nonsu2-lbfgsb": dict(norb=1, nbath=2, nspin=2, ed_mode="nonsu2",
                          beta=40.0, lfit=100, cg_method=1),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_against_jax(case):
    """chi2_fitgf against edipack_tpu's on the same target and start, as
    tests/test_torch_fit.py holds the normal-mode fits: the fitted model on
    the fit window within FIT_FACTOR times JAX's own spread."""
    kw = dict(FIT_CASES[case], cg_scheme="delta", cg_niter=200)
    jcfg, cfg = _configs(**kw)
    target = _superc_target(jcfg) if jcfg.ed_mode == "superc" \
        else _nonsu2_target(jcfg)
    start = j_bath_to_array(j_init_bath(jcfg))
    want = jfit.chi2_fitgf(jcfg, target, start, ispin=1)
    got = tfit.chi2_fitgf(cfg, target, start, ispin=1)
    want2 = jfit.chi2_fitgf(jcfg, target * (1 + 1e-12), start, ispin=1)
    gap = np.abs(_model_on_window(jcfg, got)
                 - _model_on_window(jcfg, want)).max()
    spread = np.abs(_model_on_window(jcfg, want2)
                    - _model_on_window(jcfg, want)).max()
    print(f"{case}: port gap {gap:.2e}, JAX's own spread {spread:.2e}")
    assert gap <= max(FIT_FACTOR * spread, 1e-12), (gap, spread)
