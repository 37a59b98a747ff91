"""The χ² bath fit of edipack_tpu_torch (bath/fit.py) against edipack_tpu's
(edipack_tpu/bath/fit.py): the Δ / G0 model functions, the χ² and its
autograd gradient, and whole fits through scipy, on the CPU at small sizes
(nbath <= 4, lfit <= 200, cg_niter <= 300)."""
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
from edipack_tpu.bath.functions import g0and_bath as j_g0and_bath
from edipack_tpu.bath.replica import make_basis as j_make_basis
from edipack_tpu.config import default_config as j_config

import edipack_tpu_torch.bath.fit as tfit
from edipack_tpu_torch.bath.replica import make_basis
from edipack_tpu_torch.config import default_config

torch.set_num_threads(1)
MODEL_TOL = 1e-13        # Δ and G0 against the JAX functions
GRAD_RTOL = 1e-10        # χ² and its gradient against jax.value_and_grad
# A whole fit is held to JAX's as closely as JAX's own fit is held to
# itself under a 1e-12 relative change of the target, times FIT_FACTOR: the
# stated tolerance of each case, in Δ (or G0) on the fit window. The two χ²
# agree to 1e-16 at a point, but scipy's path amplifies rounding about
# tenfold every 5 iterations, so where a fit stops moves with the last bits
# of its input; by how much depends on the case. Measured on this file's
# cases (port gap / JAX's own spread; the test prints them): CG at
# cg_niter 1.2e-5 / 1.7e-5, L-BFGS-B 2.7e-14 / 8.9e-12, BFGS 1.3e-11 /
# 1.4e-10; the largest ratio 0.71
FIT_FACTOR = 10.0


def _configs(**kw):
    return j_config(**kw), default_config(**kw)


def _replica_basis(mod_make, norb, nbath, rng):
    """Two Hermitian (1,1,Norb,Norb) basis matrices: the identity and a
    real symmetric random one; random initial lambdas."""
    sym = rng.normal(size=(norb, norb))
    ops = np.stack([np.eye(norb), sym + sym.T])[:, None, None]
    lam = rng.normal(size=(nbath, 2))
    return mod_make(ops, lam, nbath=nbath)


def _random_bath(cfg, rng, basis=None):
    """A random packed bath of cfg's layout (levels spread over [-1, 1],
    hybridizations 0.2-0.6)."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        return np.concatenate([rng.uniform(-1, 1, ns * no * nb),
                               rng.uniform(0.2, 0.6, ns * no * nb)])
    if cfg.bath_type == "hybrid":
        return np.concatenate([rng.uniform(-1, 1, ns * nb),
                               rng.uniform(0.2, 0.6, ns * no * nb)])
    per = 1 if cfg.bath_type == "replica" else ns * no
    out = [float(basis.nsym)]
    for _ in range(nb):
        out += list(rng.uniform(0.2, 0.6, per))
        out += list(rng.uniform(-1, 1, basis.nsym))
    return np.asarray(out)


@pytest.mark.parametrize("bath_type", ["normal", "hybrid", "replica",
                                       "general"])
def test_delta_and_weiss_models(bath_type):
    """Δ(z; p) and G0(z; p) of a random packed bath against
    _delta_normal_jax / _delta_replica_jax / _weiss_from_delta."""
    rng = np.random.default_rng(3)
    jcfg, cfg = _configs(norb=2, nbath=3, nspin=1, bath_type=bath_type,
                         xmu=0.3, beta=40.0)
    z = 1j * (2 * np.arange(64) + 1) * np.pi / cfg.beta
    jbasis = basis = None
    if bath_type in ("replica", "general"):
        jbasis = _replica_basis(j_make_basis, 2, 3, np.random.default_rng(5))
        basis = _replica_basis(make_basis, 2, 3, np.random.default_rng(5))
    p = _random_bath(cfg, rng, basis)
    hloc = np.array([[0.2, 0.05], [0.05, -0.1]])
    if basis is None:
        want = np.array(jfit._delta_normal_jax(jnp.asarray(p), jnp.asarray(z),
                                               jcfg, 0))
        got = tfit.delta_normal(torch.as_tensor(p), torch.as_tensor(z), cfg, 0)
    else:
        want = np.array(jfit._delta_replica_jax(
            jnp.asarray(p), jnp.asarray(z), jcfg, jbasis, 0))
        got = tfit.delta_replica(torch.as_tensor(p), torch.as_tensor(z), cfg,
                                 basis, 0)
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy() - want).max() <= MODEL_TOL * np.abs(want).max()
    g0_want = np.asarray(jfit._weiss_from_delta(
        jnp.asarray(want), jnp.asarray(z), jnp.asarray(hloc), jcfg))
    g0 = tfit.weiss_from_delta(torch.as_tensor(want), torch.as_tensor(z),
                               torch.as_tensor(hloc), cfg).numpy()
    assert np.abs(g0 - g0_want).max() <= MODEL_TOL * np.abs(g0_want).max()


def _jax_chi2(jcfg, func, p_full, fit_idx, iorb, basis, hloc):
    """The normal-mode χ² of edipack_tpu.bath.fit.chi2_fitgf, composed from
    its model functions (spin 1)."""
    nfit = min(jcfg.lfit, func.shape[-1])
    target = jnp.asarray(func[..., :nfit])
    wn = (2 * np.arange(nfit) + 1) * np.pi / jcfg.beta
    z = jnp.asarray(1j * wn)
    wts = jnp.asarray({1: np.ones(nfit), 2: 1.0 / np.arange(1, nfit + 1),
                       3: 1.0 / wn}[jcfg.cg_weight])
    no = jcfg.norb
    p_full = jnp.asarray(p_full)
    idx = jnp.asarray(fit_idx)

    def chi2(p_fit):
        p = p_full.at[idx].set(p_fit)
        if basis is not None:
            d = jfit._delta_replica_jax(p, z, jcfg, basis, 0)
        else:
            d = jfit._delta_normal_jax(p, z, jcfg, 0)
        if jcfg.cg_scheme == "weiss":
            d = jfit._weiss_from_delta(d, z, jnp.asarray(hloc), jcfg)
        diff = d - target
        if jcfg.bath_type == "normal":
            diff = diff * jnp.eye(no)[:, :, None]
        if iorb is not None:
            mask = jnp.zeros((no, no)).at[iorb - 1, iorb - 1].set(1.0)
            diff = diff * mask[:, :, None]
        if jcfg.cg_norm == "frobenius":
            fro = jnp.sqrt(jnp.sum(jnp.abs(diff) ** 2, axis=(0, 1)))
            return jnp.sum(wts * fro ** jcfg.cg_pow) / nfit \
                / (jcfg.nspin * no)
        return jnp.sum(wts * jnp.abs(diff) ** jcfg.cg_pow) / nfit

    return jax.value_and_grad(chi2)


GRAD_CASES = {
    "normal-delta-elemental": dict(bath_type="normal", cg_scheme="delta"),
    "normal-weiss-frobenius-w2": dict(bath_type="normal", cg_scheme="weiss",
                                      cg_norm="frobenius", cg_weight=2),
    "hybrid-delta-frobenius-w3": dict(bath_type="hybrid", cg_scheme="delta",
                                      cg_norm="frobenius", cg_weight=3),
    "hybrid-weiss-elemental-pow1": dict(bath_type="hybrid",
                                        cg_scheme="weiss", cg_pow=1),
    "normal-delta-iorb2": dict(bath_type="normal", cg_scheme="delta",
                               iorb=2),
    "normal-weiss-iorb1-pow1": dict(bath_type="normal", cg_scheme="weiss",
                                    iorb=1, cg_pow=1, cg_weight=3),
    "replica-delta": dict(bath_type="replica", cg_scheme="delta"),
    "general-weiss-frobenius": dict(bath_type="general", cg_scheme="weiss",
                                    cg_norm="frobenius"),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_chi2_gradient(case):
    """The port's χ² and its torch.autograd gradient at a random bath
    against jax.value_and_grad of the same χ² (masked components included:
    their gradient is 0, not NaN)."""
    kw = dict(GRAD_CASES[case])
    iorb = kw.pop("iorb", None)
    jcfg, cfg = _configs(norb=2, nbath=3, nspin=1, xmu=0.2, beta=40.0,
                         lfit=120, **kw)
    rng = np.random.default_rng(7)
    jbasis = basis = None
    if cfg.bath_type in ("replica", "general"):
        jbasis = _replica_basis(j_make_basis, 2, 3, np.random.default_rng(5))
        basis = _replica_basis(make_basis, 2, 3, np.random.default_rng(5))
    target = (rng.normal(size=(2, 2, 150)) + 1j * rng.normal(size=(2, 2, 150))
              ) * 0.1
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = [[0.1, 0.03], [0.03, -0.2]]
    p0 = _random_bath(cfg, np.random.default_rng(11), basis)
    chi2, p_full, fit_idx = tfit.chi2_function(cfg, target, p0, 1, iorb,
                                               basis, hloc)
    x = p_full.numpy()[fit_idx.numpy()] + rng.normal(scale=0.05,
                                                     size=len(fit_idx))
    val, grad = tfit.value_and_grad(chi2)(x)
    jval, jgrad = _jax_chi2(jcfg, target, p0, fit_idx.numpy(), iorb, jbasis,
                            hloc[0, 0])(jnp.asarray(x))
    jgrad = np.asarray(jgrad)
    assert np.all(np.isfinite(grad))
    assert abs(val - float(jval)) <= GRAD_RTOL * abs(float(jval))
    assert np.abs(grad - jgrad).max() <= GRAD_RTOL * np.abs(jgrad).max()
    if iorb is not None:
        # only orbital iorb's levels and hybridizations move
        nb = cfg.nbath
        assert len(fit_idx) == 2 * nb


def _fit_target(jcfg, truth_e, truth_v):
    """Δ (delta scheme) or G0 (weiss) of a known bath on lfit frequencies,
    with a small smooth misfit the model cannot absorb."""
    tb = j_init_bath(jcfg)
    tb.e[0] = truth_e
    tb.v[0] = truth_v
    z = 1j * (2 * np.arange(jcfg.lfit) + 1) * np.pi / jcfg.beta
    f = j_delta_bath(jcfg, tb, z) if jcfg.cg_scheme == "delta" \
        else j_g0and_bath(jcfg, tb, np.zeros((1, 1, jcfg.norb, jcfg.norb)), z)
    return f[0, 0] + 2e-4 * np.exp(-np.arange(jcfg.lfit) / 30.0)


def _fitted_function(jcfg, arr):
    z = 1j * (2 * np.arange(jcfg.lfit) + 1) * np.pi / jcfg.beta
    b = j_array_to_bath(arr, jcfg)
    if jcfg.cg_scheme == "delta":
        return j_delta_bath(jcfg, b, z)
    return j_g0and_bath(jcfg, b, np.zeros((1, 1, jcfg.norb, jcfg.norb)), z)


FIT_CASES = {
    "cg-delta": dict(norb=1, cg_ftol=1e-2),
    "cg-at-cap": dict(norb=1),
    "lbfgsb-weiss": dict(norb=1, cg_method=1, cg_scheme="weiss"),
    "bfgs-delta": dict(norb=1, cg_method=1, cg_minimize_ver=True),
    "lbfgsb-stop2-hybrid": dict(norb=2, cg_method=1, cg_stop=2,
                                bath_type="hybrid", cg_weight=2),
    "cg-iorb": dict(norb=2, cg_ftol=1e-3, iorb=2, cg_norm="frobenius"),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_against_jax(case):
    """chi2_fitgf against edipack_tpu's on the same target and start: the
    Δ (or G0) of the two fitted baths on the fit window."""
    kw = dict(FIT_CASES[case])
    iorb = kw.pop("iorb", None)
    kw = dict(dict(nbath=4, nspin=1, beta=50.0, lfit=200, lmats=256,
                   cg_scheme="delta", cg_niter=300), **kw)
    jcfg, cfg = _configs(**kw)
    nb, no = jcfg.nbath, jcfg.norb
    truth_e = np.tile(np.array([-0.9, -0.2, 0.3, 1.1]), (no, 1))
    truth_v = np.tile(np.array([0.35, 0.25, 0.3, 0.4]), (no, 1))
    if jcfg.bath_type == "hybrid":
        truth_e = truth_e[:1]
    target = np.stack([np.stack([_fit_target(jcfg, truth_e, truth_v)[a, b]
                                 for b in range(no)]) for a in range(no)])
    start = j_bath_to_array(j_init_bath(jcfg))
    want = jfit.chi2_fitgf(jcfg, target, start, ispin=1, iorb=iorb)
    got = tfit.chi2_fitgf(cfg, target, start, ispin=1, iorb=iorb)
    want2 = jfit.chi2_fitgf(jcfg, target * (1 + 1e-12), start, ispin=1,
                            iorb=iorb)
    gap = np.abs(_fitted_function(jcfg, got)
                 - _fitted_function(jcfg, want)).max()
    spread = np.abs(_fitted_function(jcfg, want2)
                    - _fitted_function(jcfg, want)).max()
    print(f"{case}: port gap {gap:.2e}, JAX's own spread {spread:.2e}")
    assert gap <= FIT_FACTOR * spread, (gap, spread)
    if iorb is not None:
        # the other orbital's entries are not touched by either fit
        keep = np.ones(len(start), bool)
        keep[np.concatenate([(iorb - 1) * nb + np.arange(nb),
                             no * nb + (iorb - 1) * nb + np.arange(nb)])] \
            = False
        assert np.array_equal(got[keep], start[keep])
