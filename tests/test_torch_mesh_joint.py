"""Joint-mode sectors, shared dense buckets and diverging ranks over two
gloo ranks on the CPU (edipack_tpu_torch.parallel.mesh): the row-split
padded ELL (ShardedJointMatvec) against JointMatvec, sharded superc and
nonsu2 ed_solve runs against the unsharded port (after
tests/test_sharded_superc.py, ``lanc_dim_threshold=32`` so that the large
sectors split), a two-site solve_impurity_sites whose shared eigh buckets
equal the unsharded ones, and ranks that diverge raising within their
group's timeout. The ranks are spawned once for the file
(tests/torch_mesh_ranks.py); the unsharded port runs in a process of its
own beside them."""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R

torch.set_num_threads(1)
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, gimp=1e-8)
EXTRA = {"superc": ("impf", "phisc"), "nonsu2": ("mag",)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(2, tmp_path_factory.mktemp("mesh_joint"))
    yield p
    p.close()


def _close(got, ref, keys, what):
    for key in keys:
        err = np.abs(np.asarray(got[key]) - np.asarray(ref[key])).max()
        assert err <= TOL.get(key, 1e-8), (what, key, err)


@pytest.mark.parametrize("name", ["superc", "nonsu2"])
def test_sharded_joint_ell_rows(pool, name):
    """Each rank's rows of the row-split ELL (the e-ph tables absent here)
    equal JointMatvec's, on a flat vector and a (3, dim) block."""
    res = pool.run("sharded_joint", name=name)
    assert sum(r["local_dim"] for r in res) == res[0]["dim"]
    for r in res:
        assert r["flat"] and r["block"], r


@pytest.mark.parametrize("name", ["superc", "nonsu2"])
def test_sharded_joint_solve_matches_port(pool, name, tmp_path,
                                          monkeypatch):
    """superc / nonsu2 ed_solve through the ELL on two ranks: sectors above
    4·32 states split, both ranks return the same numbers, and they match
    the unsharded port's (G, F, φ, magnetization too)."""
    monkeypatch.chdir(tmp_path)
    pool.submit("port_solve", kind="joint", name=name)
    pool.submit_solo("port_solve", kind="joint", name=name)
    ranks = pool.collect()
    plain = pool.collect_solo()
    keys = list(TOL) + list(EXTRA[name])
    assert plain["gathers"] == 0
    for r in ranks:
        assert r["gathers"] > 0
        for key in keys:
            assert np.array_equal(r[key], ranks[0][key]), key
    _close(ranks[0], plain, keys, name)


def test_sites_share_buckets(pool):
    """A two-site sweep on two ranks: every dense bucket chunk of more than
    one sector is shared, each dense sector's eigenvalues equal the
    unsharded sweep's bit for bit, and each site's e0, dens, docc and G
    match it (the (3,3) and (2,3) sectors of both sites split too)."""
    pool.submit("sites_solve")
    pool.submit_solo("sites_solve")
    ranks = pool.collect()
    plain = pool.collect_solo()
    assert plain["shared"] == [] and len(ranks[0]["shared"]) > 0
    assert ranks[0]["shared"] == ranks[1]["shared"]
    for r in ranks:
        for site, ref in zip(r["sites"], plain["sites"]):
            assert site["dense_evals"].keys() == ref["dense_evals"].keys()
            for i, ev in ref["dense_evals"].items():
                assert np.array_equal(site["dense_evals"][i], ev), i
            _close(site, ref, TOL, "site")


def test_diverging_ranks_raise(pool):
    """eigsh_lowest asked for a different nev on each rank: both ranks
    raise MeshError at its first collective, at once."""
    res = pool.run("diverge_agree")
    for r in res:
        assert r["raised"] and "disagree" in r["raised"], r
        assert r["seconds"] < R.DIVERGE_TIMEOUT


def test_missing_collective_times_out(pool):
    """Rank 0 enters an all-reduce that rank 1 never makes, on a group
    with a DIVERGE_TIMEOUT s timeout: rank 0 raises when it runs out, and
    nothing hangs."""
    res = pool.run("diverge_timeout")
    assert res[1]["raised"] is None
    assert res[0]["raised"] is not None
    assert R.DIVERGE_TIMEOUT * 0.5 <= res[0]["seconds"] \
        <= R.DIVERGE_TIMEOUT * 3, res[0]
