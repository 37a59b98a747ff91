"""edipack_tpu_torch's NumPy host layer against edipack_tpu's: sectors,
interaction matrix, bath, sector operators and the fused-kernel metadata
must be bit-identical."""
import dataclasses

import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import bath_to_array as j_bath_to_array
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.models.normal import build_normal_sector_op as j_build_op
from edipack_tpu.ops.fused_normal import build_fused_normal as j_build_fused
from edipack_tpu.sectors import SectorTable as JTable
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.bath.dmft_bath import bath_to_array, init_bath
from edipack_tpu_torch.convert import bath_from_array, config_from_jax
from edipack_tpu_torch.models.normal import build_normal_sector_op
from edipack_tpu_torch.ops.fused_normal import build_fused_normal, ell_table
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)

KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
# (name, config kwargs, sector (nup, ndw), hloc diagonal)
CASES = {
    "config1": (dict(norb=1, nbath=4, nspin=1), (2, 3), [0.0]),
    "kanamori": (dict(norb=2, nbath=3, nspin=1, **KANAMORI), (4, 3),
                 [0.1, -0.2]),
    "phonon": (dict(norb=1, nbath=1, nspin=1, uloc=[1.0], nph=3, w0_ph=0.7,
                    g_ph=[0.4], a_ph=0.1), (1, 1), [0.0]),
}


def _pair(kw, qn):
    """(jax op, port op, jax cfg, port cfg) for one sector."""
    jcfg = j_config(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    norb = jcfg.norb
    hloc = np.zeros((1, 1, norb, norb))
    jb = j_init_bath(jcfg)
    b = bath_from_array(j_bath_to_array(jb), cfg)
    jsec = JTable(jcfg).by_qn(("n", (qn[0],), (qn[1],)))
    sec = SectorTable(cfg).by_qn(("n", (qn[0],), (qn[1],)))
    jop = j_build_op(jcfg, jsec, hloc, j_umatrix(jcfg), jb)
    op = build_normal_sector_op(cfg, sec, hloc, build_umatrix(cfg), b)
    return jop, op, jcfg, cfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_sector_table(name):
    kw = CASES[name][0]
    jt, t = JTable(j_config(**kw)), SectorTable(
        config_from_jax(dataclasses.asdict(j_config(**kw))))
    assert len(jt) == len(t)
    assert list(jt.qns) == list(t.qns)
    for i in range(len(t)):
        assert jt.get_dim(i) == t.get_dim(i)
        assert np.array_equal(jt.sector(i).ups, t.sector(i).ups)
        assert np.array_equal(jt.sector(i).dws, t.sector(i).dws)
        assert jt.cdg_sector(i, 0) == t.cdg_sector(i, 0)
        assert jt.c_sector(i, 0) == t.c_sector(i, 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_umatrix_and_bath(name):
    kw = CASES[name][0]
    jcfg = j_config(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    jum, um = j_umatrix(jcfg), build_umatrix(cfg)
    for f in ("uloc", "ust", "ustp", "jx", "jp", "mf_hloc"):
        assert np.array_equal(getattr(jum, f), getattr(um, f)), f
    assert np.array_equal(j_bath_to_array(j_init_bath(jcfg)),
                          bath_to_array(init_bath(cfg)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sector_operator(name):
    kw, qn, _ = CASES[name]
    jop, op, _, _ = _pair(kw, qn)
    for f in ("d", "hup", "hdw", "ph_mat", "ph_x", "eph_d", "eph_up",
              "eph_dw"):
        a, b = getattr(jop, f), getattr(op, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f
    for a, b in zip(jop.d_factors, op.d_factors):
        assert np.array_equal(a, b)
    assert (jop.nl_perm is None) == (op.nl_perm is None)
    if op.nl_perm is not None:
        for a, b in zip(jop.nl_perm, op.nl_perm):
            assert np.array_equal(a, b)
    assert jop.nnz_estimate() == op.nnz_estimate()
    assert np.array_equal(jop.to_dense(), op.to_dense())


@pytest.mark.parametrize("kw,qn", [
    (dict(norb=2, nbath=4, nspin=1, **KANAMORI), (5, 4)),
    (dict(norb=2, nbath=3, nspin=1, **KANAMORI), (4, 4)),
    (dict(norb=1, nbath=4, nspin=1), (2, 3)),
])
def test_fused_metadata(kw, qn):
    jop, op, jcfg, cfg = _pair(kw, qn)
    jf, f = j_build_fused(jop, jcfg.norb), build_fused_normal(op, cfg.norb)
    assert jf is not None and f is not None
    for name in ("dd", "du", "ddp", "dup", "nnz"):
        assert getattr(jf, name) == getattr(f, name), name
    for name, jname in (("perm_up", "perm_up"), ("perm_dw", "perm_dw"),
                        ("diag_a", "diag_a64"), ("diag_b", "diag_b64")):
        a, b = getattr(jf, jname), getattr(f, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert [dataclasses.astuple(r) for r in jf.nl_runs] == \
        [dataclasses.astuple(r) for r in f.nl_runs]
    # the kernels' ELL tables hold the permuted factors exactly; in f32
    # they are the TPU package's f32 (hi) blocks, and in f64 its hi + lo
    # blocks to their precision
    hi_lo = dataclasses.replace(
        jf, up_vals=jf.up_vals.astype(np.float64) + jf.up_vals_lo,
        dw_vals=jf.dw_vals.astype(np.float64) + jf.dw_vals_lo)
    for idx, val, h, j_hi, j_ds in (
            (f.up_ell_idx, f.up_ell_val, _permuted(op.hup, f.perm_up, f.dup),
             jf.dense_hup(), hi_lo.dense_hup()),
            (f.dw_ell_idx, f.dw_ell_val, _permuted(op.hdw, f.perm_dw, f.ddp),
             jf.dense_hdw(), hi_lo.dense_hdw())):
        assert val.dtype == np.float64 and idx.dtype == np.int32
        dense = _ell_dense(idx, val)
        assert np.array_equal(dense, h)
        assert np.array_equal(dense.astype(np.float32), j_hi)
        assert np.abs(dense - j_ds).max() <= 1e-13 * max(np.abs(h).max(), 1.0)


def _permuted(h, perm, n):
    """The factor in the imp-MSB order, zero-padded to n."""
    out = np.zeros((n, n))
    out[:len(perm), :len(perm)] = h[np.ix_(perm, perm)]
    return out


def _ell_dense(idx, val):
    n = idx.shape[1]
    h = np.zeros((n, n), val.dtype)
    np.add.at(h, (np.broadcast_to(np.arange(n), idx.shape), idx), val)
    return h


def _random_sparse(n, seed):
    """A square matrix with empty rows, a full row and 0-3 entries
    elsewhere."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n))
    for i in range(n):
        cols = rng.choice(n, size=rng.integers(0, 4), replace=False)
        h[i, cols] = rng.normal(size=len(cols))
    h[[0, 5]] = 0.0
    h[7] = rng.normal(size=n)
    return h


@pytest.mark.parametrize("case", ["up", "dw", "random", "empty"])
def test_ell_table(case):
    """ell_table rebuilds its matrix exactly: width is the largest row
    count, a row's nonzeros fill its first slots in column order, and the
    empty slots (whole empty rows too) hold 0 and the row's own index."""
    if case in ("up", "dw"):
        _, op, _, cfg = _pair(dict(norb=2, nbath=4, nspin=1, **KANAMORI),
                              (5, 4))
        h = op.hup if case == "up" else op.hdw
    else:
        h = _random_sparse(37, 3) if case == "random" else np.zeros((9, 9))
    idx, val = ell_table(h)
    counts = np.count_nonzero(h, axis=1)
    assert idx.shape == val.shape == (max(counts.max(), 1), h.shape[0])
    assert np.array_equal(_ell_dense(idx, val), h)
    rows = np.broadcast_to(np.arange(h.shape[0]), idx.shape)
    filled = np.arange(idx.shape[0])[:, None] < counts[None, :]
    assert np.array_equal(val != 0, filled)
    assert np.array_equal(idx[~filled], rows[~filled])
    assert np.all(np.diff(np.where(filled, idx, h.shape[0]), axis=0)[
        filled[1:]] > 0)


def test_convert_roundtrip():
    jcfg = j_config(norb=2, nbath=3, nspin=1, **KANAMORI)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    arr = np.random.default_rng(5).normal(size=j_bath_to_array(
        j_init_bath(jcfg)).size)
    assert np.array_equal(bath_to_array(bath_from_array(arr, cfg)), arr)
    with pytest.raises(ValueError):
        config_from_jax({"norb": 1, "not_a_field": 3})
