"""Normal-mode sectors split over two gloo ranks on the CPU
(edipack_tpu_torch.parallel.mesh): B1/B2's row range and the dw-sharded
KronMatvec against their whole products, and sharded ed_solve runs against
the unsharded port and the edipack_tpu package, after
tests/test_sharded_solve.py's two cases cut to sectors of at most 4900
states, with ``lanc_dim_threshold`` lowered so that the largest sectors
split (dim > 4·threshold, even dw dimension). The ranks are spawned once
for the file (tests/torch_mesh_ranks.py); the unsharded port runs in a
process of its own beside them while this one runs the JAX solve."""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from edipack_tpu_torch.ops import fused_matvec as fm
from edipack_tpu_torch.ops.fused_normal import build_fused_normal

torch.set_num_threads(1)
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, gimp=1e-8)
OP_RTOL = 1e-13          # a rank's rows of KronMatvec (exact in practice)


# the case also solved by edipack_tpu (one JAX solve, about 20 s here)
JAX_CASE = "n2b6_hybrid"


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(2, tmp_path_factory.mktemp("mesh_normal"))
    yield p
    p.close()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_row_range_equals_whole_rows(dtype):
    """fused_matvec's plain version on a row range (uneven, crossing the
    Jx/Jp runs' rows and the padding rows) equals those rows of the whole
    product bit for bit; the kernel's launcher refuses what the plain
    version refuses."""
    op, cfg = R.normal_op(*R.FUSED)
    fop = build_fused_normal(op, cfg.norb)
    ops = fm.FusedOperands(fop, torch.device("cpu"), dtype)
    rng = np.random.default_rng(3)
    v3 = torch.as_tensor(rng.normal(size=(ops.nbu * ops.ddp, 128)),
                         dtype=dtype)
    whole = fm.fused_matvec(v3, ops).view(ops.nbu, ops.ddp, 128)
    assert len(fop.nl_runs) == 4 and fop.ddp > fop.dd
    for row0, nrows in ((0, fop.ddp), (0, 128), (128, 128), (37, 100),
                        (fop.dd - 3, fop.ddp - fop.dd + 3), (255, 1),
                        (5, 0)):
        part = fm.fused_matvec(v3, ops, rows=(row0, nrows))
        assert part.shape == (ops.nbu * nrows, 128)
        assert torch.equal(part.view(ops.nbu, nrows, 128),
                           whole[:, row0:row0 + nrows]), (row0, nrows)
    with pytest.raises(ValueError):
        fm.fused_matvec(v3, ops, rows=(200, 100))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_fused_rows_equal_whole(pool, dtype):
    """ShardedFusedKron (B1 / B2's plain version on each rank's rows, from
    the gathered V3) equals FusedKron's rows bit for bit, the gathered
    result its whole product, and the padding rows stay zero."""
    res = pool.run("sharded_fused", dtype=dtype)
    assert [r["rows"] for r in res] == [(0, 128), (128, 128)]
    for r in res:
        assert r["equal"] and r["gathered_equal"] and r["pad_zero"], r


@pytest.mark.parametrize("name,dense_nl,f32_vector", [
    ("kanamori", False, False), ("kanamori", True, False),
    ("phonon", False, False), ("kanamori", False, True)])
def test_sharded_kron_matches_whole(pool, name, dense_nl, f32_vector):
    """ShardedKronMatvec: V·Hupᵀ local, Hdw rows and the non-local terms
    (permutation and dense forms) from the gathered V, phonon terms; on a
    flat vector and on a (3, dim) block, as the batched GF chains call
    it; ``f32_vector``: float32 vectors promoted to the float64 operator's
    dtype, as KronMatvec promotes them. All-reduces give the exact sum."""
    res = pool.run("sharded_kron", name=name, dense_nl=dense_nl,
                   f32_vector=f32_vector)
    assert sum(r["local_dim"] for r in res) == res[0]["dim"]
    for r in res:
        assert r["batched"] and r["dense"] == dense_nl
        assert r["has_ph"] == (name == "phonon")
        assert r["out_dtype"] == "torch.float64"
        assert r["sums"] == [True, True]
        assert r["flat"] <= OP_RTOL and r["block"] <= OP_RTOL, r


def _jax_solve(name, monkeypatch):
    """The same case through edipack_tpu's solve_impurity on one device."""
    import jax
    from edipack_tpu.bath.dmft_bath import array_to_bath, bath_to_array
    from edipack_tpu.bath.dmft_bath import init_bath
    from edipack_tpu.config import default_config
    from edipack_tpu.solver.core import solve_impurity
    from edipack_tpu.umatrix import build_umatrix
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    config, hloc = R.normal_case(name)
    cfg = default_config(ed_verbose=0, **config)
    bath = array_to_bath(R.seeded_bath(bath_to_array(init_bath(cfg))), cfg)
    res = solve_impurity(cfg, hloc, build_umatrix(cfg), bath)
    z = 1j * np.pi / cfg.beta * (2 * np.arange(R.NMATS) + 1)
    return dict(e0=float(res.e0), dens=np.asarray(res.dens),
                docc=np.asarray(res.docc), gimp=np.asarray(res.get_gimp(z)))


def _close(got, ref, what):
    for key, tol in TOL.items():
        err = np.abs(np.asarray(got[key]) - np.asarray(ref[key])).max()
        assert err <= tol, (what, key, err)


@pytest.mark.parametrize("name", ["n1b7", "n2b6_hybrid"])
def test_sharded_solve_matches_port(pool, name, tmp_path, monkeypatch):
    """ed_solve on two ranks: the (4,4) sector (4900 states, dw 70) splits
    through ShardedKronMatvec (its GF chains too) and the dense buckets
    are shared; both ranks return the same numbers, which match the
    unsharded port's (n2b6_hybrid, with twin sectors: inter-orbital Hloc
    and Jx/Jp, so the non-local terms cross the ranks' rows); that case
    also matches the JAX package's solve."""
    monkeypatch.chdir(tmp_path)
    pool.submit("port_solve", kind="normal", name=name)
    pool.submit_solo("port_solve", kind="normal", name=name)
    ref_jax = _jax_solve(name, monkeypatch) if name == JAX_CASE else None
    ranks = pool.collect()
    plain = pool.collect_solo()
    assert plain["gathers"] == 0
    for r in ranks:
        assert r["gathers"] > 0 and r["threads"] == 1
        for key in TOL:
            assert np.array_equal(r[key], ranks[0][key]), key
    _close(ranks[0], plain, "sharded vs unsharded port")
    if ref_jax is not None:
        _close(ranks[0], ref_jax, "sharded port vs edipack_tpu")
        _close(plain, ref_jax, "unsharded port vs edipack_tpu")
