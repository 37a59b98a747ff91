"""The C library of edipack_tpu_torch under a process group, on the CPU:
the ``edtpu_site`` and ``compat_site`` drivers (capi/drivers/) launched as
two processes with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set, as
``torchrun --no-python`` would, join one gloo group at ``edtpu_init``
(capihelp.join_group), and the (3,3) sector of 400 states splits over the
ranks (lanc_dim_threshold 80; B1's row ranges as their plain version).
Each rank's printed numbers are held to the one-process driver's (1e-8)
and to edipack_tpu's Python API (e0 1e-10, the rest 1e-8, as
tests/test_torch_capi.py holds the one-process drivers); only rank 0
writes files; the verbose line names the mesh. A rank whose peer never
starts fails ``edtpu_init`` within the group timeout, with the message in
``edtpu_last_error()``. Skips only where gcc or Python.h is absent."""
import json
import os
import shutil
import socket
import subprocess
import sysconfig
import time

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.config import default_config as j_config
from edipack_tpu.config import set_config as j_set_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_capi.py's SITE, with the DMFT fit of compat_site by
# L-BFGS-B on the solve's grid (a reproducible fit)
SITE = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
            jx=0.15, jp=0.15, xmu=0.3, beta=40.0, lmats=16, lfit=16,
            cg_method=1, cg_scheme="delta")
# the library's route: (3,3) (400 states > 4·80, dw 20) splits over two
# ranks through B1's row ranges; files written, the mesh line printed
MESH = dict(lanc_dim_threshold=80, ed_fused_matvec="always",
            ed_write_files=True, ed_verbose=2)
RANK_TOL = 1e-8           # a rank against the one-process driver
TOL = dict(e0=1e-10, obs=1e-8, gimp=1e-8)
GROUP_TIMEOUT = 8         # seconds: the lone rank's rendezvous
KEYS = ("EVALS", "DENS", "DOCC", "MAGZ", "EIMP", "G", "NB", "FIT")

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or not os.path.exists(
        os.path.join(sysconfig.get_paths()["include"], "Python.h")),
    reason="the C library needs gcc and Python.h")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Build the library and the two drivers; run each once alone and
    once on two ranks, and one rank 0 whose peer never starts, all at
    once: {(driver, where): (returncode, stdout, stderr, files, seconds)}
    with ``where`` "solo", 0, 1 or "lone"."""
    from edipack_tpu_torch.capi import build
    lib = build.build()
    out = tmp_path_factory.mktemp("capi_mesh")
    inp = out / "site.in"
    with open(inp, "w") as fh:
        for k, v in {**SITE, **MESH}.items():
            v = ",".join(map(str, v)) if isinstance(v, list) else v
            fh.write(f"{k.upper()}={v}\n")
    args = {"edtpu_site": [str(inp), 1, SITE["norb"], SITE["lmats"]],
            "compat_site": [str(inp)]}
    exes = {}
    for name in args:
        exes[name] = str(out / name)
        r = subprocess.run(
            ["gcc", "-O2", "-Wall", *build.include_flags(), "-o", exes[name],
             os.path.join(build.CAPI_DIR, "drivers", name + ".c"),
             *build.link_flags(lib)], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                EDIPACK_TPU_TORCH_DEVICE="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        base.pop(k, None)
    jobs = {}
    for name in args:
        log = str(out / f"{name}_{{rank}}.json")
        jobs[name, "solo"] = dict(base, EDIPACK_TPU_TORCH_LAUNCH_LOG=str(
            out / f"{name}_solo.json"))
        port = _free_port()
        for rank in (0, 1):
            jobs[name, rank] = dict(
                base, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                EDIPACK_TPU_TORCH_GROUP_TIMEOUT="120",
                EDIPACK_TPU_TORCH_LAUNCH_LOG=log)
    jobs["edtpu_site", "lone"] = dict(
        base, RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(_free_port()),
        EDIPACK_TPU_TORCH_GROUP_TIMEOUT=str(GROUP_TIMEOUT))
    procs = {}
    for (name, where), env in jobs.items():
        cwd = out / f"{name}_{where}"
        cwd.mkdir()
        procs[name, where] = (cwd, time.monotonic(), subprocess.Popen(
            [exes[name], *map(str, args[name])], cwd=str(cwd), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = {}
    for key, (cwd, t0, p) in procs.items():
        try:
            so, se = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        res[key] = (p.returncode, so, se, sorted(os.listdir(cwd)),
                    time.monotonic() - t0)
    for name in args:       # each process's mesh collectives, by its log
        for where in ("solo", 0, 1):
            with open(out / f"{name}_{where}.json") as fh:
                res[name, where, "log"] = json.load(fh)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _values(run):
    rc, so, se, _, _ = run
    assert rc == 0, so[-2000:] + se[-3000:]
    assert "Traceback" not in se, se[-3000:]
    vals = {}
    for line in so.splitlines():
        name, *rest = line.split()
        if name in KEYS:
            assert len(rest) == int(rest[0]) + 1, line[:80]
            vals[name] = np.array([float(x) for x in rest[1:]])
    return vals


@pytest.mark.parametrize("name", ["edtpu_site", "compat_site"])
def test_ranks_match_one_process(runs, name):
    """Both ranks print the one-process driver's numbers (1e-8), name the
    mesh and gathered their split sector's vectors (their launch logs,
    one path a rank by ``{rank}``); only rank 0 writes files (the
    one-process driver writes the same ones)."""
    solo = _values(runs[name, "solo"])
    assert "Mesh(" not in runs[name, "solo"][1]
    assert runs[name, "solo", "log"]["gathers"] == 0
    for rank in (0, 1):
        assert runs[name, rank, "log"]["gathers"] > 0
    for rank in (0, 1):
        got = _values(runs[name, rank])
        assert got.keys() == solo.keys()
        for key, want in solo.items():
            dev = np.abs(got[key] - want).max()
            assert dev <= RANK_TOL, (rank, key, dev)
        assert f"Mesh(backend=gloo, world=2, rank={rank}, device=cpu)" \
            in runs[name, rank][1]
    files = runs[name, 0][3]
    assert files and files == runs[name, "solo"][3]
    assert runs[name, 1][3] == [], runs[name, 1][3]


def test_ranks_match_jax(runs, tmp_path, monkeypatch):
    """The edtpu_site ranks and the compat_site ranks against edipack_tpu's
    ed_solve of the same configuration in this process, and the
    compat_site fit against its ed_chi2_fitgf."""
    import jax
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.chdir(tmp_path)
    cfg = j_set_config(j_config(**SITE, ed_verbose=0))
    try:
        bath = jed.ed_init_solver(cfg=cfg)
        jed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
        res = jed.ed_solve(bath)
        want = dict(DENS=jed.ed_get_dens(), DOCC=jed.ed_get_docc(),
                    EIMP=jed.ed_get_eimp())
        g = jed.ed_get_gimp()
        fit = jed.ed_chi2_fitgf(g, bath, ispin=1)
        evals = np.sort(jed.ed_get_evals())
        magz = jed.ed_get_mag("z")
    finally:
        jed.ed_finalize_solver()
    for rank in (0, 1):
        site = _values(runs["edtpu_site", rank])
        assert np.abs(np.sort(site["EVALS"]) - evals).max() <= TOL["e0"]
        assert abs(site["EVALS"].min() - res.e0) <= TOL["e0"]
        assert np.abs(site["MAGZ"] - magz).max() <= TOL["obs"]
        gc = site["G"][0::2] + 1j * site["G"][1::2]
        assert np.abs(gc.reshape(g.shape) - g).max() <= TOL["gimp"]
        compat = _values(runs["compat_site", rank])
        gf = compat["G"][0::2] + 1j * compat["G"][1::2]
        assert np.abs(gf.reshape(g.shape, order="F") - g).max() \
            <= TOL["gimp"]
        assert np.abs(compat["FIT"] - fit).max() <= 1e-7
        for key, w in want.items():
            for got in (site[key], compat[key]):
                assert np.abs(got - w).max() <= TOL["obs"], (rank, key)


def test_lone_rank_fails_init(runs):
    """WORLD_SIZE=2 and no peer: edtpu_init fails once the group timeout
    runs out, and the driver prints edtpu_last_error()."""
    rc, so, se, files, seconds = runs["edtpu_site", "lone"]
    assert rc == 1, (so[-2000:], se[-2000:])
    assert so.startswith("ERR edipack_tpu_torch: rank 0 of 2 could not "
                         "join the gloo group"), so[:400]
    assert "EVALS" not in so and files == []
    assert seconds <= 6 * GROUP_TIMEOUT, seconds
