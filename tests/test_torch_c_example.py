"""The C example of edipack_tpu_torch (edipack_tpu_torch/examples/c/
hm_bethe.c) on the CPU: built by examples/c/build.py against
libedipack_tpu_torch_c.so, run with EDIPACK_TPU_TORCH_DEVICE=cpu. With its
loop capped at 1 (HM_BETHE_NLOOP) the impG_iw.ed it writes holds
edipack_tpu's ed_solve G at the same parameters (1e-8 of its largest
value); capped at 2 (argv) it runs its bath fit and a second solve and
prints finite numbers. Skips only where gcc or Python.h is absent."""
import math
import os
import re
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

import edipack_tpu.main as jed
from edipack_tpu.config import default_config as j_config
from edipack_tpu.config import set_config as j_set_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hm_bethe.c's parameters
MODEL = dict(norb=1, nbath=5, nspin=1, beta=100.0, lmats=512, lfit=512,
             uloc=[2.0], xmu=0.0, cg_scheme="delta", cg_niter=600)
GTOL = 1e-8
LOOP = re.compile(r"loop +(\d+) +err (\S+) +dens (\S+)")

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or not os.path.exists(
        os.path.join(sysconfig.get_paths()["include"], "Python.h")),
    reason="the C library needs gcc and Python.h")


@pytest.fixture(scope="module")
def program():
    from edipack_tpu_torch.examples.c import build
    exe = build.build()
    assert exe.parent == build.BUILD_DIR and os.access(exe, os.X_OK)
    return str(exe)


def _run(program, cwd, *args, **env):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDIPACK_TPU_TORCH_DEVICE="cpu", **env)
    out = subprocess.run([program, *args], capture_output=True, text=True,
                         env=env, cwd=str(cwd), timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Traceback" not in out.stderr, out.stderr[-3000:]
    loops = [tuple(float(x) for x in m.groups())
             for m in LOOP.finditer(out.stdout)]
    assert re.search(r"done: dens=\S+; wrote impG_iw.ed", out.stdout)
    return loops


def test_one_loop_against_jax_solve(program, tmp_path, monkeypatch):
    loops = _run(program, tmp_path, HM_BETHE_NLOOP="1")
    assert [n for n, _, _ in loops] == [1]
    w, img, reg = np.loadtxt(tmp_path / "impG_iw.ed", unpack=True)
    import jax
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.chdir(tmp_path)
    cfg = j_set_config(j_config(**MODEL, ed_verbose=0))
    jed.ed_init_solver(cfg=cfg)
    jed.ed_set_hloc(np.zeros((1, 1, 1, 1)))
    jed.ed_solve()
    try:
        want = jed.ed_get_gimp()[0, 0, 0, 0]
        dens = float(jed.ed_get_dens()[0])
    finally:
        jed.ed_finalize_solver()
    assert np.allclose(w, np.pi / MODEL["beta"] * (2 * np.arange(512) + 1))
    got = reg + 1j * img
    assert np.abs(got - want).max() <= GTOL * np.abs(want).max()
    assert abs(loops[0][2] - dens) <= 5e-7            # printed as %.6f


def test_two_loops_finish(program, tmp_path):
    loops = _run(program, tmp_path, "2")
    assert [n for n, _, _ in loops] == [1, 2]
    assert all(math.isfinite(x) for loop in loops for x in loop)
    assert 0.0 < loops[1][1] < 1.0                    # the mixed Δ moved
    assert np.all(np.isfinite(np.loadtxt(tmp_path / "impG_iw.ed")))
