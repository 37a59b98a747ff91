"""The blocked joint Kron split over two gloo ranks on the CPU
(edipack_tpu_torch.models.joint_kron.ShardedJointKronMatvec, every
(Nup, Ndw) block's dw rows a rank): each rank's rows against the whole
port operator and, gathered, against edipack_tpu's JointKronMatvec; the
superc and nonsu2 ed_solve with ``ed_joint_kron="always"`` against the
unsharded port; the joint golden's phonon case through the sharded Kron
against the JAX numbers; and the routing of ``ed_joint_kron="always"``
beside ``ed_sparse_h=False`` (the Kron, as in the JAX package). The ranks
are spawned once for the file (tests/torch_mesh_ranks.py); the unsharded
port runs in a process of its own beside them."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import joint_cases as jc
import torch_mesh_ranks as R
from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.config import default_config as j_config
from edipack_tpu.models.joint_kron import build_joint_kron_op as j_kron
from edipack_tpu.sectors import SectorTable as JSectorTable
from edipack_tpu.umatrix import build_umatrix as j_umatrix

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_golden_joint.json")
OP_RTOL = 1e-12           # gathered rows against the JAX operator
ROWS_RTOL = 1e-14         # a rank's rows against the whole port operator
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, gimp=1e-8)
EXTRA = {"superc": ("impf", "phisc"), "nonsu2": ("mag",)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(2, tmp_path_factory.mktemp("mesh_kron"))
    yield p
    p.close()


def _jax_products(name, v):
    """edipack_tpu's blocked Kron (no mesh) applied to each row of ``v``,
    in the sorted basis."""
    config, hloc, qn = R.joint_kron_case(name)
    cfg = j_config(ed_verbose=0, **config)
    sec = JSectorTable(cfg).by_qn(qn)
    op = j_kron(cfg, sec, hloc, j_umatrix(cfg), j_init_bath(cfg))
    return np.stack([np.asarray(op.from_internal_flat(
        op(op.to_internal_flat(jnp.asarray(x))))) for x in v])


@pytest.mark.parametrize("name", ["superc", "nonsu2", "phonon"])
def test_sharded_kron_rows(pool, name):
    """The sector's operator under the mesh is the sharded Kron (its
    ed_verbose=4 line says ``sharded``). Each rank's rows of it, on a flat
    vector and a (3, dim) block, equal the whole port operator's within
    1e-14; gathered and
    taken to the sorted basis, they equal edipack_tpu's
    build_joint_kron_op(...)(v) within 1e-12 relative, on both ranks."""
    res = pool.run("sharded_joint_kron", name=name)
    assert sum(r["local_dim"] for r in res) == res[0]["dim"]
    want = _jax_products(name, res[0]["v"])
    scale = np.abs(want).max()
    for r in res:
        assert r["type"] == "ShardedJointKronMatvec"
        assert r["debug"].endswith(" sharded") and "-> Sharded" in r["debug"]
        assert r["flat"] <= ROWS_RTOL and r["block"] <= ROWS_RTOL, r
        assert r["gathers"] == 2, r["gathers"]      # one a matvec
        assert np.abs(r["sorted"] - want).max() <= OP_RTOL * scale
        assert np.abs(r["sorted_flat"] - want[0]).max() <= OP_RTOL * scale
    if name == "phonon":        # blocks of one dw row: rank 1 owns none
        assert (1, 1) in [tuple(x) for x in res[1]["rows"]]


@pytest.mark.parametrize("name", ["superc", "nonsu2"])
def test_sharded_kron_solve_matches_port(pool, name, tmp_path, monkeypatch):
    """superc / nonsu2 ed_solve through the blocked Kron on two ranks:
    sectors above 4·150 states split, both ranks return the same numbers,
    and they match the unsharded port's (G, F, φ, magnetization too)."""
    monkeypatch.chdir(tmp_path)
    route = dict(ed_joint_kron="always")
    pool.submit("port_solve", kind="joint", name=name, **route)
    pool.submit_solo("port_solve", kind="joint", name=name, **route)
    ranks = pool.collect()
    plain = pool.collect_solo()
    assert plain["gathers"] == 0
    for r in ranks:
        assert r["gathers"] > 0
        for key in list(TOL) + list(EXTRA[name]):
            assert np.array_equal(r[key], ranks[0][key]), key
    for key in list(TOL) + list(EXTRA[name]):
        err = np.abs(np.asarray(ranks[0][key]) - np.asarray(plain[key])).max()
        assert err <= TOL.get(key, 1e-8), (key, err)


def test_sharded_kron_phonon_golden(pool, tmp_path, monkeypatch):
    """The joint golden's phonon case (lanc_dim_threshold 16: its Sz=0
    sector of 80 states splits) through the sharded Kron on two ranks,
    held to the JAX numbers of tests/data/torch_port_golden_joint.json at
    the golden's tolerances."""
    monkeypatch.chdir(tmp_path)
    res = pool.run("joint_golden_case", name="phonon",
                   ed_joint_kron="always")
    with open(GOLDEN) as fh:
        gold = json.load(fh)["cases"]["phonon"]
    for r in res:
        assert r.pop("gathers") > 0
        dev = jc.deviations(r, jc.from_json(gold, r))
        bad = {k: v for k, v in dev.items() if not v <= jc.TOL[k]}
        assert not bad, bad


def test_kron_before_direct(tmp_path, monkeypatch):
    """ed_joint_kron="always" with ed_sparse_h=False: every Sz sector goes
    through the blocked Kron, as edipack_tpu routes them, and the solve
    (the joint golden's phonon case) meets the golden's tolerances."""
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.joint_kron import JointKronMatvec
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.solver.core_joint import joint_builders
    from edipack_tpu_torch.umatrix import build_umatrix
    monkeypatch.chdir(tmp_path)
    route = dict(ed_joint_kron="always", ed_sparse_h=False)
    case = jc.CASES["phonon"]
    cfg = default_config(**case["config"], **route)
    table = SectorTable(cfg)
    b = joint_builders(cfg, table, case["hloc"], build_umatrix(cfg),
                       init_bath(cfg), torch.device("cpu"))
    types = {type(b.matvec_builder(table.sector(i)))
             for i in range(len(table))}
    assert types == {JointKronMatvec}, types
    got = jc.run_case(jc.modules("edipack_tpu_torch"), case, device="cpu",
                      **route)
    with open(GOLDEN) as fh:
        gold = json.load(fh)["cases"]["phonon"]
    dev = jc.deviations(got, jc.from_json(gold, got))
    bad = {k: v for k, v in dev.items() if not v <= jc.TOL[k]}
    assert not bad, bad
