"""The benchmark of edipack_tpu_torch on NVIDIA cards.

    python3 edbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One cell is one configuration (``edbench/configs/``) under one traffic mix
(``edbench/traffic/``), named by ``edbench/cells/<cell>.json`` and
``BENCHMARK.json``. A run drives the port's functional API in one process
on one card, as a DMFT loop does: ``ed_init_solver``, ``ed_set_hloc``,
then ``ed_solve`` on the same solver again and again in a closed loop with
one client, each solve on a new bath from the seed. A configuration with
``ed_sectors`` and listed ``restart_sectors`` is restricted to those
sectors (widened by ``ed_sectors_shift``) by the ``sectors`` restart file
that set-up writes into a per-run output directory under ``TMPDIR``. After
each solve the loop reads back what a DMFT driver needs (G, Σ, F in
superc, densities, double occupancies, energies) through the reference
module that the configuration names (``reference``), which also gives its
default bath, the program's layouts of bath and Hloc, and the reference's
answers.

Set-up (``setup_s``: from the start of this script through imports, CUDA
initialization, the program's libraries, ``ed_init_solver`` and one
warm-up solve of the cell's sectors) is followed by the window: solves
are started while less than ``--seconds`` have passed, and each runs to
its end. ``--trace 1`` then runs a span of whole solves under
``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones. Once the window has closed and the program's state is
freed, a sample of the window's solves, drawn from the seed, is solved
again by that plain reference and compared; each number compared is
printed beside its limit on stderr and under ``checks`` in the result,
the last line of stdout. A listed metric whose reader finds nothing to
read is named under ``missing``, and on stderr.

The run fails without a result when CUDA is missing or short of the cell's
cards, when the program cannot be imported, and when the process has
loaded ``jax``, ``jaxlib``, ``flax`` or ``edipack_tpu``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "edipack_tpu"}


def _cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = root / "build" / "edbench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.pop("EDIPACK_TPU_TORCH_PROFILE_DIR", None)


class Context:
    """What the metric readers read (``edbench/metrics/<name>.py``)."""

    def __init__(self, params: dict, setup_s: float, solves: List[dict],
                 trace: Optional[dict]):
        self.params = params
        self.setup_s = setup_s
        self.solves = solves
        self.trace = trace

    def seconds_per_solve(self) -> Optional[float]:
        """The window's span, first solve's start to last solve's end,
        over its solves."""
        if not self.solves:
            return None
        return (self.solves[-1]["t1"] - self.solves[0]["t0"]) \
            / len(self.solves)

    def phase_mean(self, phase: str) -> Optional[float]:
        vals = [s["timings"][phase] for s in self.solves
                if phase in s["timings"]]
        return sum(vals) / len(vals) if vals else None

    def matvecs_mean(self) -> Optional[float]:
        vals = [s["matvecs"] for s in self.solves]
        return sum(vals) / len(vals) if vals else None

    def device_group_per_solve(self, group: str) -> Optional[float]:
        t = self.trace
        if not t or not t["n_solves"] or group not in t["groups"]:
            return None
        return t["groups"][group] / t["n_solves"]

    def idle_pct(self) -> Optional[float]:
        t = self.trace
        if not t or t["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

    def b1_roofline_pct(self) -> Optional[float]:
        """Least time of the span's B1 launches (yardstick, per sector)
        over B1's device time there, in %."""
        from edbench.core import yardstick
        t = self.trace
        if not t or not t["launches"] or t["b1_device_s"] <= 0:
            return None
        p = self.params
        jx, jp = bool(p.get("jx", 0.0)), bool(p.get("jp", 0.0))
        least = sum(n * yardstick.bound(*yardstick.normal_sector_work(
            p["norb"], p["nbath"], lab[0], lab[1], jx, jp))
            for lab, n in t["launches"].items())
        return 100.0 * least / t["b1_device_s"]


def start_solver(ed, ref, conf: dict, outdir: str, device: str) -> None:
    """``ed_init_solver`` and ``ed_set_hloc`` of a configuration (``ref``:
    its reference module, which gives the program's layout of Hloc). With
    ``ed_sectors`` and listed ``restart_sectors``, set-up writes them as
    the ``sectors`` restart file into ``outdir``, the solver's output
    directory; otherwise it writes none."""
    from edipack_tpu_torch.config import default_config
    params = conf["params"]
    cfg = default_config(**params, ed_verbose=0, ed_output_dir=outdir)
    if params.get("ed_sectors") and conf.get("restart_sectors"):
        with open(os.path.join(outdir, cfg.sectorfile + ".restart"),
                  "w") as fh:
            for lab in conf["restart_sectors"]:
                fh.write(" ".join(str(int(x)) for x in lab) + "\n")
    ed.ed_init_solver(cfg=cfg, device=device)
    ed.ed_set_hloc(ref.program_hloc(conf))


def _bad_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None, root: Path = ROOT, device: Optional[str] = None) -> int:
    """``device``: None on the card (the run fails without enough CUDA
    cards); a test passes "cpu" to run the rest of the flow there."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from edbench.core import check, traffic
    from edbench.core.registry import Registry

    reg = Registry(root)
    entry = reg.workload(args.workload)
    cell = reg.cell(args.workload)
    conf = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"edbench: {args.workload} needs {entry['chips']} CUDA "
                  f"card(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda"
        _cache_dirs(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    import edipack_tpu_torch.main as ed

    ref = check.load_reference(root, conf)
    params = conf["params"]
    flag_gf = bool(mix.get("flag_gf", True))
    base = ref.default_bath(params)
    outdir = tempfile.mkdtemp(prefix=f"edbench_{args.workload}_",
                              dir=os.environ.get("TMPDIR"))
    try:
        start_solver(ed, ref, conf, outdir, device)
        warm = traffic.baths(base, mix, args.seed, stream=0)
        for _ in range(mix.get("warmup_solves", 1)):
            ed.ed_solve(ref.pack(next(warm)), flag_gf=flag_gf)
        sync()
        setup_s = time.perf_counter() - T_START

        stream = traffic.baths(base, mix, args.seed, stream=1)
        solves: List[dict] = []
        baths: List[dict] = []
        failed = 0
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < args.seconds:
            bath = next(stream)
            t0 = time.perf_counter()
            try:
                res = ed.ed_solve(ref.pack(bath), flag_gf=flag_gf)
                sync()
                rec = ref.read_back(ed, res, params, flag_gf)
            except Exception as exc:     # a failed solve counts as failed
                print(f"edbench: solve {len(solves) + failed} failed: "
                      f"{type(exc).__name__}: {exc}", file=sys.stderr)
                failed += 1
                continue
            finally:
                res = None
            rec.update(t0=t0, t1=time.perf_counter())
            print(f"edbench: window solve {len(solves)}: "
                  f"{rec['t1'] - t0:.4f} s; "
                  + ", ".join(f"{k} {v:.4f} s"
                              for k, v in rec["timings"].items()),
                  file=sys.stderr)
            solves.append(rec)
            baths.append(bath)

        trace = None
        if args.trace:
            from edbench.core import trace as tr

            def span():
                for _ in range(cell["trace_solves"]):
                    with torch.profiler.record_function(tr.SOLVE_SPAN):
                        ed.ed_solve(ref.pack(next(stream)), flag_gf=flag_gf)
                return cell["trace_solves"]

            trace = tr.profile(span, outdir)

        peak = int(torch.cuda.max_memory_allocated()) \
            if dev.type == "cuda" else 0
        ed.ed_finalize_solver()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the comparison: a sample of the window's solves, from the seed
        rng = np.random.default_rng([int(args.seed) & 0xFFFFFFFFFFFFFFFF, 2])
        k = min(cell["check_solves"], len(solves))
        picks = sorted(rng.choice(len(solves), size=k, replace=False)) \
            if k else []
        ref_dtype = getattr(torch, conf["reference_dtype"])
        rows = []
        for i in picks:
            answer = ref.solve(conf, baths[i], ref_dtype, dev, flag_gf)
            rows.append(check.compare(solves[i], answer))
            print(f"edbench: reference of window solve {i}: "
                  f"{answer['seconds']['states']:.2f} s to the kept states, "
                  f"{answer['seconds']['rest']:.2f} s to the rest",
                  file=sys.stderr)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        limits = cell["limits"]
        worst = check.worst(rows) if rows else {}
        numbers = {k: worst.get(k, float("inf")) for k in limits}
        correct = bool(rows) and failed == 0 \
            and check.verdict(numbers, limits)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    ctx = Context(params, setup_s, solves, trace)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = reg.read_metrics(args.workload, kind, ctx)
    missing = [m["name"] for m in reg.metrics(args.workload, kind)
               if m["name"] not in metrics]
    result = dict(correct=correct, attempted=len(solves) + failed,
                  failed=failed, metrics=metrics,
                  device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                              kind=torch.cuda.get_device_name(0)
                              if dev.type == "cuda" else "cpu",
                              count=entry["chips"], memory_peak_bytes=peak))
    if trace is not None:
        result["device"].update(busy_s=trace["busy_s"],
                                window_s=trace["window_s"])
        result["breakdown"] = trace["breakdown"]
    if missing:
        # a metric listed for this cell whose reader found nothing to read
        result["missing"] = missing
        print(f"edbench: no reading of {', '.join(missing)}",
              file=sys.stderr)
    result["checks"] = {k: {"value": numbers[k] if np.isfinite(numbers[k])
                            else None, "limit": limits[k]} for k in limits}
    bad = _bad_modules()
    if bad:
        print(f"edbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
