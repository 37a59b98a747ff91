"""A checkout-shaped directory holding tiny copies of the benchmark's
cells (Nbath 2, 64 Matsubara points), for CPU tests of the harness: the
repo's own configuration, traffic, cell and metric files, each tiny cell
added as new files and BENCHMARK.json entries, as a later change adds one."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# the cells (their files under edbench/cells/) and the sectors of their
# tiny copies' kept states; the superc cell's files are kept for a later
# superc cell, outside BENCHMARK.json
TINY = {"kanamori2_nb6.restart_gf": ("tiny_normal", [[2, 4], [4, 2]]),
        "superc2_nb4.restart_gf": ("tiny_superc", [[0]])}


def make(root: Path) -> dict:
    """Builds the directory; returns {repo cell: tiny cell}."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "edbench", root / "edbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {}
    for src_cell, (tiny, labels) in TINY.items():
        cell = json.loads((root / "edbench/cells" / f"{src_cell}.json")
                          .read_text())
        src = cell["config"]
        conf = json.loads((root / "edbench/configs" / f"{src}.json")
                          .read_text())
        conf["restart_sectors"] = labels
        conf["params"].update(nbath=2, lmats=64, lanc_dim_threshold=16)
        (root / "edbench/configs" / f"{tiny}.json").write_text(
            json.dumps(conf))
        cell["config"] = tiny
        name = src_cell.replace(src, tiny)
        (root / "edbench/cells" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append(dict(name=name, config=tiny,
                                       traffic=cell["traffic"], chips=1,
                                       why="CPU tests"))
        bench["configs"].append(dict(name=tiny, source="tiny copy",
                                     file=f"edbench/configs/{tiny}.json",
                                     reduced=["nbath"], why="CPU tests"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if src_cell in m.get("workloads", []):
                m["workloads"].append(name)
        names[src_cell] = name
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return names


def run(root: Path, cell: str, seconds: float = 3.0, seed: int = 2**31 + 5,
        capsys=None):
    """One CPU run of the harness; returns (exit code, result or None)."""
    import torch
    from edbench import run as harness
    torch.set_num_threads(2)
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", "0"], root=root, device="cpu")
    result = None
    if capsys is not None:
        lines = capsys.readouterr().out.strip().splitlines()
        if lines and lines[-1].startswith("{"):
            result = json.loads(lines[-1])
    return rc, result
