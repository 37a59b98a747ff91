"""edipack_tpu_torch must load without JAX or edipack_tpu: the machine with
the card has no JAX installed; nor may the C library over it name any
module but its own."""
import glob
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import sys
sys.path.insert(0, {root!r})
import edipack_tpu_torch, edipack_tpu_torch.main, edipack_tpu_torch.convert
import edipack_tpu_torch.ops.fused_matvec, edipack_tpu_torch.ops._build
import edipack_tpu_torch.ops.kron_tiles
import edipack_tpu_torch.bath.fit, edipack_tpu_torch.bath.user
import edipack_tpu_torch.io, edipack_tpu_torch.solver.mu_search
import edipack_tpu_torch.examples.hm_bethe
import edipack_tpu_torch.solver.chi, edipack_tpu_torch.solver.rdm
import edipack_tpu_torch.solver.krylov
import edipack_tpu_torch.models.joint, edipack_tpu_torch.models.joint_kron
import edipack_tpu_torch.solver.core_joint, edipack_tpu_torch.solver.soc
import edipack_tpu_torch.ops.sector_ops, edipack_tpu_torch.ops.matvec
import edipack_tpu_torch.ineq, edipack_tpu_torch.capihelp
import edipack_tpu_torch.compat, edipack_tpu_torch.capi.build
import edipack_tpu_torch.device, edipack_tpu_torch.solver.greens
import edipack_tpu_torch.ops.lanczos, edipack_tpu_torch.profile_solve
import edipack_tpu_torch.examples.c.build, edipack_tpu_torch.parallel.mesh
import edipack_tpu_torch.native
assert edipack_tpu_torch.native.available()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "edipack_tpu"))
print(",".join(bad))
"""


def test_import_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["EDIPACK_TPU_TORCH_DEVICE"] = "cpu"    # capihelp's device
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py fails, printing no result, where CUDA is absent (here)
    — the same check the script makes first on the card."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_c_library_imports_only_the_port():
    """Every module the C sources import (PyImport_ImportModule) is an
    edipack_tpu_torch module."""
    names = []
    for path in glob.glob(os.path.join(ROOT, "edipack_tpu_torch", "capi",
                                       "*.c")):
        with open(path) as fh:
            names += re.findall(r'PyImport_ImportModule\(\s*"([^"]+)"',
                                fh.read())
    assert len(names) >= 6, names
    assert all(n == "edipack_tpu_torch" or n.startswith("edipack_tpu_torch.")
               for n in names), names
