"""Finds what a run needs by name, from files alone.

* ``BENCHMARK.json`` at the checkout's root: cells, metrics, units.
* ``edbench/cells/<cell>.json``: the configuration and traffic mix a cell
  runs, and the limits of its correctness check.
* the ``file`` of a configuration's ``BENCHMARK.json`` entry
  (``edbench/configs/<config>.json``): the configuration as it is run,
  which names its plain reference (``edbench/reference/<name>.py``).
* ``edbench/traffic/<mix>.json``: a traffic mix's parameters.
* ``edbench/metrics/<metric>.py``: the reader of one metric, a module with
  ``read(ctx) -> float | None``.

A later change adds a cell, configuration, mix or metric by adding files
and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "edbench"
        self.benchmark = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.bench_dir / kind / f"{name}.json"
        if not path.is_file():
            raise SystemExit(f"edbench: no {kind[:-1]} named {name!r} "
                             f"({path.relative_to(self.root)})")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"edbench: BENCHMARK.json has no workload {name!r}")

    def cell(self, name: str) -> dict:
        """The cell's file, checked against its BENCHMARK.json entry."""
        entry = self.workload(name)
        cell = self._json("cells", name)
        for key in ("config", "traffic"):
            if cell[key] != entry[key]:
                raise SystemExit(f"edbench: cell {name}: {key} {cell[key]!r} "
                                 f"in its file, {entry[key]!r} in "
                                 f"BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        """The file that the configuration's BENCHMARK.json entry names."""
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"edbench: BENCHMARK.json has no configuration "
                         f"{name!r}")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        that list it under ``workloads``, or list no workloads."""
        return [m for m in self.benchmark[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise SystemExit(f"edbench: no reader for metric {metric!r} "
                             f"({path.relative_to(self.root)})")
        spec = importlib.util.spec_from_file_location(
            f"edbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def read_metrics(self, cell: str, kind: str, ctx) -> Dict[str, dict]:
        """{name: {"value", "unit"}} of every metric the cell reports whose
        reader finds something to read."""
        out = {}
        for m in self.metrics(cell, kind):
            value: Optional[float] = self.reader(m["name"])(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
