"""What decides ``correct``: the solves of the window, a sample drawn from
the seed, each solved again by the configuration's plain reference (the
module its ``reference`` names) from its own bath and compared with what
the program returned.

Numbers compared, each the worst over the sampled solves:

* ``kept_mismatch``: kept states whose sector the other side lacks
  (multiset difference of the sectors of the kept states);
* ``e_kept``: largest |ΔE| of the kept levels, matched in order;
* ``<name>_rel`` for each function the reference gives (G, Σ, F on the
  configuration's Matsubara grid: ``g_rel``, ``sigma_rel``, ``f_rel``):
  largest |Δ| over the largest |value| of the reference's function;
* ``obs_abs``: largest |Δ| of the reference's observables (densities,
  double occupancies, energies, and |φ| in superc).
"""
from __future__ import annotations

import importlib.util
from collections import Counter
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np


def load_reference(root: Path, conf: dict) -> ModuleType:
    """The module a configuration's ``reference`` names, a path under the
    checkout's root (``edbench/reference/<name>.py``)."""
    path = Path(root) / conf["reference"]
    if not path.is_file():
        raise SystemExit(f"edbench: no reference {conf['reference']!r}")
    spec = importlib.util.spec_from_file_location(
        "edbench.reference." + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared for one solve."""
    pk = sorted((tuple(l), e) for l, e in prog["kept"])
    rk = sorted((tuple(l), e) for l, e in ref["kept"])
    cp, cr = Counter(l for l, _ in pk), Counter(l for l, _ in rk)
    out = dict(kept_mismatch=float(sum(((cp - cr) + (cr - cp)).values())))
    n = min(len(pk), len(rk))
    out["e_kept"] = float(max(abs(pk[i][1] - rk[i][1]) for i in range(n))) \
        if n else float("inf")
    for key, val in ref.get("functions", {}).items():
        out[key + "_rel"] = _rel(prog["functions"][key], val)
    out["obs_abs"] = float(max(
        np.abs(np.asarray(prog["observables"][k]) - np.asarray(v)).max()
        for k, v in ref["observables"].items()))
    return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    keys = rows[0].keys()
    return {k: max(r[k] for r in rows) for k in keys}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number present, finite and within its limit."""
    return all(np.isfinite(numbers.get(k, np.inf)) and numbers[k] <= lim
               for k, lim in limits.items())
