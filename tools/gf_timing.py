"""Walls of the port's joint-mode solves with the GF chains batched and
one at a time, on a CUDA card. A measurement script, not part of the
package:

    python3 tools/gf_timing.py

For config 3 (superc; the ELL and blocked-Kron routes) and config 4
(nonsu2; the ELL and direct routes), as ``edipack_tpu_torch/
profile_solve.py config3`` / ``config4`` set them up, it runs one cold
``ed_solve`` (builds and warm-up), then four in turns: one chain at a time
(``solver.greens.BATCH_CHAINS`` off), batched, batched, one at a time;
each line gives the wall, the phases and the e0. On the Kron route it then
runs two more batched solves with the (B, dim) blocks applied eagerly
instead of through their CUDA graphs (``apply()``; one vector still
replays its graph), and one more with the graphs, in turns.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from edipack_tpu_torch.device import synchronize  # noqa: E402
from edipack_tpu_torch.solver import greens  # noqa: E402


@contextlib.contextmanager
def kron_blocks_eager():
    """JointKronMatvec applies a (B, dim) block eagerly (no CUDA graph)
    inside the block; one vector still replays its graph."""
    from edipack_tpu_torch.models.joint_kron import JointKronMatvec
    graph_call = JointKronMatvec.__call__

    def call(self, v):
        if v.dim() == 1:
            return graph_call(self, v)
        self.n_calls += 1
        return self.apply(v)

    JointKronMatvec.__call__ = call
    try:
        yield
    finally:
        JointKronMatvec.__call__ = graph_call


def timed_solve(label: str, cfg, hloc, device: torch.device) -> dict:
    """One ed_solve of ``cfg``: wall, phases and e0, printed."""
    from edipack_tpu_torch import main as ed
    from edipack_tpu_torch.config import set_config
    set_config(cfg)
    bath = ed.ed_init_solver(cfg=cfg, device=device)
    ed.ed_set_hloc(hloc)
    synchronize(device)
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    synchronize(device)
    wall = time.perf_counter() - t0
    ed.ed_finalize_solver()
    print(f"[gf_timing] {label}: wall {wall:.3f} s, "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items())
          + f"; e0 {res.e0:.12f}, matvecs {res.n_matvecs}", flush=True)
    return dict(wall=wall, gf=res.timings.get("greens_functions", 0.0),
                e0=res.e0)


def main() -> int:
    from edipack_tpu_torch.profile_solve import problem
    if not torch.cuda.is_available():
        raise SystemExit("gf_timing: needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    routes = (("config3", "ell", {}),
              ("config3", "kron", dict(ed_joint_kron="always")),
              ("config4", "ell", {}),
              ("config4", "direct", dict(ed_sparse_h=False)))
    for name, route, kw in routes:
        cfg, hloc = problem(name)
        cfg = cfg.replace(**kw)
        tag = f"{name} {route}"
        timed_solve(f"{tag} cold", cfg, hloc, dev)
        runs = {"single": [], "batched": []}
        for kind in ("single", "batched", "batched", "single"):
            with mock.patch.object(greens, "BATCH_CHAINS",
                                   kind == "batched"):
                runs[kind].append(timed_solve(f"{tag} {kind}", cfg, hloc,
                                              dev))
        if route == "kron":
            runs["eager"] = []
            runs["graph"] = []
            for kind in ("eager", "graph", "eager"):
                ctx = kron_blocks_eager() if kind == "eager" \
                    else contextlib.nullcontext()
                with ctx:
                    runs[kind].append(timed_solve(f"{tag} batched {kind}",
                                                  cfg, hloc, dev))
            runs["graph"] += runs["batched"]
        for kind, rs in runs.items():
            walls = [r["wall"] for r in rs]
            gfs = [r["gf"] for r in rs]
            de0 = max(abs(r["e0"] - rs[0]["e0"]) for r in rs)
            print(f"[gf_timing] {tag} {kind}: walls "
                  + ", ".join(f"{w:.3f}" for w in walls) + " s, GF "
                  + ", ".join(f"{g:.3f}" for g in gfs)
                  + f" s (median wall {np.median(walls):.3f} s, GF "
                  f"{np.median(gfs):.3f} s); e0 spread {de0:.1e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
