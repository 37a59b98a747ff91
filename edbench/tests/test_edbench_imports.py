"""Whole top-level module names: nothing the harness loads is jax, jaxlib,
flax or the JAX package edipack_tpu, and the plain reference loads nothing
of edipack_tpu_torch."""
import subprocess
import sys
from pathlib import Path

from edbench.tests import tiny

REPO = tiny.REPO


def _modules_after(code: str, tmp_path: Path) -> set:
    out = tmp_path / "mods.txt"
    prog = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n{code}\n"
            f"open({str(out)!r}, 'w').write('\\n'.join("
            f"sorted({{m.split('.')[0] for m in sys.modules}})))")
    subprocess.run([sys.executable, "-c", prog], check=True, timeout=600,
                   cwd=tmp_path)
    return set(out.read_text().split())


def test_reference_loads_no_port(tmp_path):
    mods = _modules_after(
        "import edbench.reference.kanamori, edbench.reference.model, "
        "edbench.reference.lanczos, edbench.core.check, "
        "edbench.core.traffic, edbench.core.yardstick", tmp_path)
    assert "edipack_tpu_torch" not in mods
    assert not mods & {"jax", "jaxlib", "flax", "edipack_tpu"}


def test_harness_run_loads_no_jax(tmp_path):
    root = tmp_path / "checkout"
    tiny.make(root)
    mods = _modules_after(
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\nfrom edbench import run\n"
        f"assert run.main(['--workload', 'tiny_superc.restart_gf', "
        f"'--seed', '3', '--seconds', '1', '--trace', '0'], "
        f"root=Path({str(root)!r}), device='cpu') == 0", tmp_path)
    assert "edipack_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "edipack_tpu"}


def test_run_refuses_without_cards(tmp_path):
    """On a machine without CUDA the run exits non-zero and prints no
    result."""
    p = subprocess.run([sys.executable, str(REPO / "edbench/run.py"),
                        "--workload", "kanamori2_nb6.restart_gf", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env={"CUDA_VISIBLE_DEVICES": "",
                                          "PATH": "/usr/bin:/bin"})
    import torch
    if torch.cuda.is_available():
        return
    assert p.returncode != 0
    assert not p.stdout.strip()
