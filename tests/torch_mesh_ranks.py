"""Two gloo ranks on the CPU for the port's mesh tests
(tests/test_torch_mesh_*.py): a pool of rank processes started once per
test file, and the cases they run.

``RankPool(world, store_dir)`` spawns ``world`` processes; each joins a
gloo group through a ``file://`` store under ``store_dir`` (no TCP port,
so parallel test workers never collide) with a group timeout of
``TIMEOUT`` seconds, pins one thread, and then runs the cases it is sent,
by name, one after another. ``submit(case, **kw)`` sends one to every
rank, ``collect()`` returns each rank's result in rank order and raises
with the rank's traceback if one failed. One more process joins no group
(``submit_solo`` / ``collect_solo``): it runs the unsharded port beside
the ranks while the test process runs the JAX package. This module
imports no JAX.
"""
from __future__ import annotations

import datetime
import os
import queue
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TIMEOUT = 60            # seconds: the default group of the ranks
DIVERGE_TIMEOUT = 10    # seconds: the group of the divergence case
NMATS = 16


def _worker(rank, world, store, cmd_q, res_q):
    """A rank of the group (``store`` given) or the solo process."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if store is not None:
        try:
            dist.init_process_group(
                "gloo", init_method=f"file://{store}", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=TIMEOUT))
        except Exception:                                 # noqa: BLE001
            res_q.put((rank, False, traceback.format_exc()))
            return
    while True:
        item = cmd_q.get()
        if item is None:
            break
        case, kw = item
        try:
            res_q.put((rank, True, globals()[case](**kw)))
        except Exception:                                 # noqa: BLE001
            res_q.put((rank, False, traceback.format_exc()))
    if store is not None:
        dist.destroy_process_group()


class RankPool:
    """``world`` rank processes on one gloo group (see the module
    docstring)."""

    def __init__(self, world: int, store_dir: str):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world = world
        store = os.path.join(str(store_dir), "gloo_store")
        self.res_q = ctx.Queue()
        self.cmd_qs = [ctx.Queue() for _ in range(world)]
        self.solo_cmd_q, self.solo_res_q = ctx.Queue(), ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, store, self.cmd_qs[r],
                                        self.res_q))
                      for r in range(world)]
        self.procs.append(ctx.Process(
            target=_worker, daemon=True,
            args=(0, 1, None, self.solo_cmd_q, self.solo_res_q)))
        for p in self.procs:
            p.start()

    def submit(self, case: str, **kw) -> None:
        for q in self.cmd_qs:
            q.put((case, kw))

    def submit_solo(self, case: str, **kw) -> None:
        self.solo_cmd_q.put((case, kw))

    @staticmethod
    def _gather(res_q, n: int, timeout: float, raise_errors: bool):
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, ok, val = res_q.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"mesh ranks: no answer from ranks "
                                   f"{sorted(set(range(n)) - set(out))}"
                                   f" in {timeout} s") from None
            out[rank] = (ok, val)
        if not raise_errors:
            return [out[r] for r in range(n)]
        for r in range(n):
            if not out[r][0]:
                raise RuntimeError(f"mesh rank {r} failed:\n{out[r][1]}")
        return [out[r][1] for r in range(n)]

    def collect(self, timeout: float = 120.0, raise_errors: bool = True):
        """Each rank's result of the last submit, in rank order (with
        ``raise_errors=False``, (ok, result or traceback) pairs)."""
        return self._gather(self.res_q, self.world, timeout, raise_errors)

    def collect_solo(self, timeout: float = 120.0):
        """The solo process's result of the last submit_solo."""
        return self._gather(self.solo_res_q, 1, timeout, True)[0]

    def run(self, case: str, **kw):
        self.submit(case, **kw)
        return self.collect()

    def close(self) -> None:
        for q in self.cmd_qs + [self.solo_cmd_q]:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()


# ---------------------------------------------------------------------------
# the cases (run on every rank, and unsharded in the test process)
# ---------------------------------------------------------------------------

KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)


def normal_case(name: str):
    """(config kwargs, hloc) of the normal-mode solves,
    after tests/test_sharded_solve.py's two cases."""
    if name == "n1b7":
        return (dict(norb=1, nbath=7, nspin=1, uloc=[2.0], xmu=0.2,
                     beta=100.0, lmats=NMATS, lanc_dim_threshold=1000),
                np.zeros((1, 1, 1, 1)))
    if name == "n2b6_hybrid":
        hloc = np.zeros((1, 1, 2, 2))
        hloc[0, 0] = [[-0.1, 0.25], [0.25, 0.1]]
        return (dict(norb=2, nbath=6, nspin=1, bath_type="hybrid",
                     uloc=[1.8, 1.8], ust=0.9, jh=0.3, jx=0.3, jp=0.3,
                     xmu=1.1, beta=80.0, lmats=NMATS,
                     lanc_dim_threshold=1000, ed_twin=True), hloc)
    raise KeyError(name)


def joint_case(name: str):
    """After tests/test_sharded_superc.py's two cases (nonsu2 at nbath=2,
    so that its largest sectors, 924 and 792 states, split; 50-step GF
    chains, as each step of a split chain gathers its whole block)."""
    if name == "superc":
        hloc = np.zeros((1, 1, 2, 2))
        hloc[0, 0] = np.diag([0.2, -0.2])
        return (dict(norb=2, nbath=2, nspin=1, ed_mode="superc",
                     uloc=[-1.5, -1.5], ust=-0.8, jh=0.1, jx=0.1, jp=0.1,
                     deltasc=0.05, xmu=0.15, beta=200.0, lmats=NMATS,
                     lanc_dim_threshold=150, lanc_ngfiter=50), hloc)
    if name == "nonsu2":
        hloc = np.zeros((2, 2, 2, 2))
        hloc[0, 0] = np.diag([0.3, -0.3])
        hloc[1, 1] = np.diag([0.3, -0.3])
        return (dict(norb=2, nbath=2, nspin=2, ed_mode="nonsu2",
                     uloc=[1.2, 1.2], ust=0.6, jh=0.15, jx=0.15, jp=0.15,
                     xmu=0.1, beta=200.0, lmats=NMATS,
                     lanc_dim_threshold=150, lanc_ngfiter=50,
                     spin_field_x=[0.08, 0.03]),
                hloc)
    raise KeyError(name)


def seeded_bath(bath_array: np.ndarray, seed: int = 11) -> np.ndarray:
    """The packed bath with a numpy-seeded perturbation (the same on every
    rank and in the test process)."""
    rng = np.random.default_rng(seed)
    return bath_array + rng.normal(scale=0.05, size=bath_array.shape)


def port_solve(kind: str, name: str, device: str = "cpu", **extra) -> dict:
    """One ed_solve of a case through the port's entry points: the numbers
    the tests compare, and the mesh's collectives (parallel.mesh counts)
    that it made."""
    import torch
    import edipack_tpu_torch.main as ted
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.parallel import mesh as pm
    config, hloc = (normal_case if kind == "normal" else joint_case)(name)
    pm.n_gathers = pm.n_reduces = 0
    cfg = default_config(**{"ed_verbose": 0, **config, **extra})
    bath0 = ted.ed_init_solver(cfg=cfg, device=device)
    bath = seeded_bath(np.asarray(bath0))
    ted.ed_set_hloc(hloc)
    res = ted.ed_solve(bath)
    z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
    out = dict(e0=float(res.e0), dens=np.asarray(ted.ed_get_dens()),
               docc=np.asarray(ted.ed_get_docc()),
               gimp=np.asarray(ted.ed_get_gimp(z)),
               gathers=pm.n_gathers, reduces=pm.n_reduces,
               threads=torch.get_num_threads())
    if cfg.ed_mode == "superc":
        out["impf"] = np.asarray(ted.ed_get_gimp(z, typ="a"))
        out["phisc"] = np.asarray(res.phisc)
    if cfg.ed_mode == "nonsu2":
        out["mag"] = np.asarray(res.mag)
    return out


# -- operators: a rank's rows against the whole product ---------------------

# nbath=4 (5,4): ddp = dup = 256, four Jx/Jp runs, the padding rows 210..255
FUSED = (dict(norb=2, nbath=4, nspin=1, **KANAMORI), (5, 4))
# the sectors of KronMatvec's branches: permutation non-local terms
# (Kanamori), phonons, and the dense non-local einsum
KRON = {
    "kanamori": (dict(norb=2, nbath=3, nspin=1, **KANAMORI), (4, 3)),
    "phonon": (dict(norb=1, nbath=1, nspin=1, uloc=[1.0], nph=3, w0_ph=0.7,
                    g_ph=[0.4], a_ph=0.1), (1, 1)),
}


def normal_op(config: dict, qn):
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    cfg = default_config(ed_verbose=0, **config)
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    hloc[0, 0] = np.diag([0.1, -0.2][:cfg.norb])
    sec = SectorTable(cfg).by_qn(("n", (qn[0],), (qn[1],)))
    return build_normal_sector_op(cfg, sec, hloc, build_umatrix(cfg),
                                  init_bath(cfg)), cfg


class DenseNl:
    """A sector operator whose non-local factors are given as dense stacks
    only (one row with two entries), so that KronMatvec takes its einsum
    branch."""

    def __init__(self, base):
        self.__dict__.update(vars(base))
        self.nl_a = base.nl_a.copy()
        self.nl_a[0, 0, :2] += 0.01
        self.nl_b = base.nl_b
        self.nl_perm = None


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def sharded_fused(dtype: str) -> dict:
    """B1 (float64) or B2 (float32) on this rank's row range through
    ShardedFusedKron against this rank's rows of FusedKron's whole
    product (their plain versions on the CPU)."""
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    from edipack_tpu_torch.parallel.mesh import make_mesh
    cpu = torch.device("cpu")
    dt = getattr(torch, dtype)
    op, cfg = normal_op(*FUSED)
    fop = build_fused_normal(op, cfg.norb)
    whole = fm.FusedKron(fop, cpu, dt)
    mesh = make_mesh(cpu)
    part = fm.ShardedFusedKron(fop, cpu, dt, mesh)
    rng = np.random.default_rng(5)
    v = whole.v0_project(torch.as_tensor(rng.normal(size=whole.dim), dtype=dt))
    w = whole(v)
    w_loc = part(part.local(v))
    return dict(rows=part.rows, ddp=fop.ddp, dd=fop.dd, nruns=len(fop.nl_runs),
                equal=bool(torch.equal(w_loc, part.local(w))),
                gathered_equal=bool(torch.equal(part.gather(w_loc), w)),
                pad_zero=bool((w_loc.reshape(part.nbu, -1, 128)
                               [:, max(0, fop.dd - part.rows[0]):]
                               == 0).all()))


def sharded_kron(name: str, dense_nl: bool = False, batch: int = 3,
                 f32_vector: bool = False) -> dict:
    """ShardedKronMatvec against KronMatvec on a flat vector and on a
    (batch, dim) block: this rank's rows, relative to the largest entry.
    ``f32_vector``: the vectors in float32 through the float64 operator
    (computed in float64 on both); also an all-reduce of rank-dependent
    values, against its sum."""
    import torch
    from edipack_tpu_torch.ops.matvec import KronMatvec, ShardedKronMatvec
    from edipack_tpu_torch.parallel.mesh import make_mesh
    cpu = torch.device("cpu")
    op, _ = normal_op(*KRON[name])
    if dense_nl:
        op = DenseNl(op)
    whole = KronMatvec(op, cpu)
    mesh = make_mesh(cpu)
    part = ShardedKronMatvec(op, cpu, torch.float64, mesh)
    ar = [mesh.allreduce_sum(torch.arange(n, dtype=torch.float64)
                             * (mesh.rank + 1))
          for n in (5, 10000)]
    rng = np.random.default_rng(6)
    v = torch.as_tensor(rng.normal(size=(batch, whole.dim)))
    if f32_vector:
        v = v.to(torch.float32)
    w_flat, w_block = part(part.local(v[0])), part(part.local(v))
    flat = _max_rel(w_flat, part.local(whole(v[0])))
    block = _max_rel(w_block, part.local(whole(v)))
    sums = [bool(torch.equal(a, torch.arange(a.numel(), dtype=torch.float64)
                             * (mesh.world * (mesh.world + 1) // 2)))
            for a in ar]
    return dict(flat=flat, block=block, dim=whole.dim,
                local_dim=part.local_dim, has_ph=whole.has_ph,
                dense=whole.nl_dense is not None, batched=part.batched,
                out_dtype=str(w_block.dtype), sums=sums)


def sharded_joint(name: str, batch: int = 3) -> dict:
    """ShardedJointMatvec against JointMatvec at the largest sector of a
    joint case, flat and on a (batch, dim) block."""
    import torch
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.joint import build_joint_sector_op
    from edipack_tpu_torch.ops.matvec import JointMatvec, ShardedJointMatvec
    from edipack_tpu_torch.parallel.mesh import make_mesh
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    cpu = torch.device("cpu")
    config, hloc = joint_case(name)
    cfg = default_config(ed_verbose=0, **config)
    table = SectorTable(cfg)
    sec = max((table.sector(i) for i in range(len(table))),
              key=lambda s: s.dim)
    op = build_joint_sector_op(cfg, sec, hloc, build_umatrix(cfg),
                               init_bath(cfg))
    whole = JointMatvec(op, cpu)
    part = ShardedJointMatvec(op, cpu, make_mesh(cpu))
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.normal(size=(batch, whole.dim))
                        + 1j * rng.normal(size=(batch, whole.dim)))
    flat = part(part.local(v[0]))
    return dict(flat=bool(torch.equal(flat, part.local(whole(v[0])))),
                block=bool(torch.equal(part(part.local(v)),
                                       part.local(whole(v)))),
                dim=whole.dim, local_dim=part.local_dim)


def joint_kron_case(name: str):
    """(config kwargs, hloc, sector qn) of the sharded blocked-Kron checks:
    the largest sector of joint_case's superc and nonsu2 cases, and the
    Sz=0 sector of the joint golden's phonon case (tests/joint_cases.py;
    two of its four blocks have one dw row, so rank 1 owns none of them)."""
    if name == "phonon":
        import joint_cases
        case = joint_cases.CASES["phonon"]
        return dict(case["config"]), case["hloc"], ("sz", 0)
    config, hloc = joint_case(name)
    return config, hloc, ("sz", 0) if name == "superc" else ("nt", 6)


def sharded_joint_kron(name: str, batch: int = 3) -> dict:
    """The sector's operator as joint_builders routes it under the mesh
    (``ed_joint_kron="always"``, with its ed_verbose=4 line), against the
    whole JointKronMatvec on a flat vector and a (batch, dim) block of
    numpy-seeded sorted-basis vectors: this rank's rows against the whole
    product's (max relative deviation), and the gathered products in the
    sorted basis (for the JAX package's operator in the test process)."""
    import contextlib
    import io
    import torch
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.joint_kron import build_joint_kron_op
    from edipack_tpu_torch.parallel import mesh as pm
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.solver.core_joint import joint_builders
    from edipack_tpu_torch.umatrix import build_umatrix
    cpu = torch.device("cpu")
    config, hloc, qn = joint_kron_case(name)
    cfg = default_config(**{**config, "ed_verbose": 4,
                            "ed_joint_kron": "always"})
    table = SectorTable(cfg)
    sec = table.by_qn(qn)
    args = (hloc, build_umatrix(cfg), init_bath(cfg))
    whole = build_joint_kron_op(cfg, sec, *args, cpu)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        part = joint_builders(cfg, table, *args, cpu, mesh=pm.make_mesh(
            cpu)).matvec_builder(sec)
    rng = np.random.default_rng(8)
    v = torch.as_tensor(rng.normal(size=(batch, whole.dim))
                        + 1j * rng.normal(size=(batch, whole.dim)))
    vb = torch.stack([whole.to_internal_flat(x) for x in v])
    pm.n_gathers = 0
    w_flat, w_block = part(part.local(vb[0])), part(part.local(vb))
    ref = whole(vb)
    out = dict(dim=whole.dim, local_dim=part.local_dim, rows=part.rows,
               gathers=pm.n_gathers, type=type(part).__name__,
               debug=log.getvalue().strip(),
               flat=_max_rel(w_flat, part.local(ref[0])),
               block=_max_rel(w_block, part.local(ref)))
    full = part.gather(w_block)
    out["sorted"] = np.stack([whole.from_internal_flat(x).numpy()
                              for x in full])
    out["sorted_flat"] = whole.from_internal_flat(part.gather(w_flat)).numpy()
    out["v"] = v.numpy()
    return out


def joint_golden_case(name: str, **route) -> dict:
    """A case of the joint golden (tests/joint_cases.py run_case) through
    the port on the CPU, with the mesh's gathers it made."""
    import joint_cases
    from edipack_tpu_torch.parallel import mesh as pm
    pm.n_gathers = 0
    out = joint_cases.run_case(joint_cases.modules("edipack_tpu_torch"),
                               joint_cases.CASES[name], device="cpu",
                               **route)
    out["gathers"] = pm.n_gathers
    return out


# -- solves beyond ed_solve -------------------------------------------------

SITES = dict(norb=2, nbath=2, nspin=1, beta=40.0, xmu=0.3, lmats=NMATS,
             lanc_dim_threshold=80, lanc_ngfiter=50, **KANAMORI)


def sites_solve() -> dict:
    """A two-site solve_impurity_sites (the sites' dense sectors in shared
    eigh buckets; sectors above 4·64 states with an even dw dimension
    split): per site e0, dens, docc, G, and every dense sector's
    eigenvalues; with the number of bucket chunks the ranks shared."""
    import torch
    from edipack_tpu_torch.bath.dmft_bath import array_to_bath, init_bath
    from edipack_tpu_torch.bath.dmft_bath import bath_to_array
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.solver import diag
    from edipack_tpu_torch.solver.core import solve_impurity_sites
    from edipack_tpu_torch.umatrix import build_umatrix
    cfg = default_config(ed_verbose=0, **SITES)
    cfgs, hlocs, baths = [], [], []
    for s in range(2):
        c = cfg.replace(uloc=[2.0 + 0.5 * s] * 2)
        cfgs.append(c)
        h = np.zeros((1, 1, 2, 2))
        h[0, 0] = np.diag([0.1 * s, -0.1 * s])
        hlocs.append(h)
        baths.append(array_to_bath(
            seeded_bath(bath_to_array(init_bath(c)), seed=20 + s), c))
    shared = []
    orig = diag._shared_eigh

    def counting(mats, mesh):
        shared.append(mats.shape[0])
        return orig(mats, mesh)
    diag._shared_eigh = counting
    try:
        res = solve_impurity_sites(cfg, hlocs, [build_umatrix(c) for c in cfgs],
                                   baths, torch.device("cpu"), cfgs=cfgs)
    finally:
        diag._shared_eigh = orig
    z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
    dense = [i for i in res[0].diag.evals_by_sector
             if res[0].table.get_dim(i) <= cfg.lanc_dim_threshold]
    return dict(shared=shared, sites=[dict(
        e0=float(r.e0), dens=np.asarray(r.dens), docc=np.asarray(r.docc),
        gimp=np.asarray(r.get_gimp(z)),
        dense_evals={i: np.asarray(r.diag.evals_by_sector[i])
                     for i in dense}) for r in res])


# -- ranks that diverge -----------------------------------------------------

def diverge_agree() -> dict:
    """eigsh_lowest with a different nev on each rank: every rank raises
    MeshError at once."""
    import torch
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.ops.matvec import ShardedKronMatvec
    from edipack_tpu_torch.parallel.mesh import MeshError, make_mesh
    cpu = torch.device("cpu")
    op, _ = normal_op(*KRON["kanamori"])
    mesh = make_mesh(cpu)
    mv = ShardedKronMatvec(op, cpu, torch.float64, mesh)
    t0 = time.perf_counter()
    try:
        eigsh_lowest(mv, mv.dim, 1 + mesh.rank, mesh=mesh)
    except MeshError as exc:
        return dict(raised=str(exc), seconds=time.perf_counter() - t0)
    return dict(raised=None, seconds=time.perf_counter() - t0)


def diverge_timeout() -> dict:
    """On a group of its own with a DIVERGE_TIMEOUT s timeout, rank 0
    enters an all-reduce that rank 1 never makes: rank 0 raises when the
    timeout runs out, instead of hanging."""
    import torch
    import torch.distributed as dist
    from edipack_tpu_torch.parallel.mesh import Mesh
    group = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=DIVERGE_TIMEOUT))
    mesh = Mesh(torch.device("cpu"), group)
    t0 = time.perf_counter()
    err = None
    if mesh.rank == 0:
        try:
            mesh.allreduce_sum(torch.ones(3))
        except RuntimeError as exc:
            err = type(exc).__name__ + ": " + str(exc)[:200]
    return dict(raised=err, seconds=time.perf_counter() - t0)


def bench_collectives(n: int = 2000) -> dict:
    """Microseconds an all-reduce of one scalar and a gather of 800 values
    take between the ranks through gloo (no test reads this;
    ``RankPool.run`` it)."""
    import torch
    from edipack_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(torch.device("cpu"))
    one = torch.ones(1, dtype=torch.float64)
    t0 = time.perf_counter()
    for _ in range(n):
        mesh.allreduce_sum(one)
    t1 = time.perf_counter()
    x = torch.ones(2, 50, 8, dtype=torch.float64)
    for _ in range(n):
        mesh.all_gather_rows(x, 100, axis=-2)
    t2 = time.perf_counter()
    return dict(allreduce_us=(t1 - t0) / n * 1e6,
                gather_us=(t2 - t1) / n * 1e6)
