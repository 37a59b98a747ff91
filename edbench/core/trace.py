"""The traced span of a ``--trace 1`` run: whole solves under
``torch.profiler`` (CPU and CUDA activity), with spans from this file
around the program's layer calls and a count of fused-matvec launches per
sector, reduced to device time by kernel group, busy and idle time, and a
breakdown.

The kernel grouping is a frozen copy of
``edipack_tpu_torch/profile_solve.py:_group`` (commit a90ee7e). The spans
and the launch counter wrap program functions from outside. A name the
program no longer has fails the traced run with a message naming it, so
that a span or a metric read through it never goes silent unnoticed.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import time
from typing import Dict, List, Tuple

import torch

# (module, attribute, span label): the layer calls that the breakdown
# names the host's work by
SPANS = [
    ("edipack_tpu_torch.solver.core", "build_normal_sector_op",
     "sector build: normal operator (host)"),
    ("edipack_tpu_torch.solver.core", "build_fused_normal",
     "sector build: B1 tables (host)"),
    ("edipack_tpu_torch.solver.core_joint", "build_joint_sector_op",
     "sector build: joint COO (host)"),
    ("edipack_tpu_torch.solver.diag", "eigsh_lowest", "Lanczos ground states"),
    ("edipack_tpu_torch.solver.greens", "lanczos_tridiag", "GF chain"),
    ("edipack_tpu_torch.solver.greens", "lanczos_tridiag_batch",
     "GF chains (batched)"),
    ("edipack_tpu_torch.solver.core", "build_gf_normal", "Green's functions"),
    ("edipack_tpu_torch.solver.core_joint", "build_gf_superc",
     "Green's functions"),
    ("edipack_tpu_torch.solver.core", "compute_observables_normal",
     "observables"),
    ("edipack_tpu_torch.solver.core_joint", "compute_observables_joint",
     "observables"),
]
SOLVE_SPAN = "edbench: ed_solve"
TOP = 10


def group(name: str) -> str:
    if "row_gather_kernel<double" in name:
        return "fused matvec B1 (f64)"
    if "row_gather_kernel<float" in name:
        return "fused matvec B2 (f32)"
    low = name.lower()
    if "gemm" in low or "gemv" in low or "splitk" in low:
        return "cuBLAS gemm/gemv"
    if "htod" in low:
        return "host-to-device copies"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gathers and scatters"
    if "reduce" in low:
        return "reductions"
    return "other device work"


def _wrap_span(fn, label):
    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return inner


@contextlib.contextmanager
def instrumented():
    """Spans around the program's layer calls and a per-sector count of
    B1 launches (one a FusedKron call on the card); yields the count
    {(nup, ndw): launches}."""
    saved: List[Tuple[object, str, object]] = []
    launches: Dict[Tuple[int, int], int] = {}
    label_of: Dict[int, Tuple[int, int]] = {}

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    targets = [(m, a) for m, a, _ in SPANS] + [
        ("edipack_tpu_torch.solver.core", "build_fused_normal"),
        ("edipack_tpu_torch.ops.fused_matvec", "FusedKron")]
    lost = [f"{m}.{a}" for m, a in targets
            if not hasattr(importlib.import_module(m), a)]
    if lost:
        raise RuntimeError("edbench: the traced run wraps program names "
                           "that are gone: " + ", ".join(lost))
    for modname, attr, label in SPANS:
        mod = importlib.import_module(modname)
        patch(mod, attr, _wrap_span(getattr(mod, attr), label))
    core = importlib.import_module("edipack_tpu_torch.solver.core")
    fmv = importlib.import_module("edipack_tpu_torch.ops.fused_matvec")
    build = core.build_fused_normal

    def counted_build(op, *a, **k):
        fop = build(op, *a, **k)
        if fop is not None:
            sec = op.sector
            label_of[id(fop)] = (bin(int(sec.ups[0])).count("1"),
                                 bin(int(sec.dws[0])).count("1"))
        return fop

    call = fmv.FusedKron.__call__

    def counted_call(self, v):
        lab = label_of.get(id(self.fop))
        if lab is not None and self.dtype == torch.float64 and v.is_cuda:
            launches[lab] = launches.get(lab, 0) + 1
        return call(self, v)

    patch(core, "build_fused_normal", counted_build)
    patch(fmv.FusedKron, "__call__", counted_call)
    try:
        yield launches
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)


def profile(run_span, tmpdir: str) -> dict:
    """Run ``run_span()`` (whole solves, each inside a ``SOLVE_SPAN``
    record_function) under the profiler; returns the reduced trace."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with instrumented() as launches:
        with tprofile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_solves = run_span()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, "span.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce(events)
    out.update(window_s=window_s, n_solves=n_solves, launches=dict(launches))
    return out


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    iv = sorted(iv)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: List[dict]) -> dict:
    """Device time by group and by kernel, busy seconds (the union of
    device activity), and the longest idle gaps inside the traced solves,
    each named by the innermost span of this file that covers it."""
    dev, spans, solves = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        a, b = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((a, b, ev.get("name", "")))
        elif cat == "user_annotation":
            if ev.get("name") == SOLVE_SPAN:
                solves.append((a, b))
            else:
                spans.append((a, b, ev.get("name", "")))
    groups: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for a, b, name in dev:
        s = (b - a) * 1e-6
        groups[group(name)] = groups.get(group(name), 0.0) + s
        kernels[name] = kernels.get(name, 0.0) + s
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = []
    for lo, hi in solves:
        inside = [(max(a, lo), min(b, hi)) for a, b in merged
                  if b > lo and a < hi]
        edges = [lo] + [x for iv in inside for x in iv] + [hi]
        for i in range(0, len(edges), 2):
            if edges[i + 1] > edges[i]:
                gaps.append((edges[i], edges[i + 1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        cover = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(cover, key=lambda s: s[1] - s[0])[2] if cover \
            else "host: outside the traced layer calls"
        named.append([name, (b - a) * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(groups=groups, busy_s=busy,
                b1_device_s=groups.get("fused matvec B1 (f64)", 0.0),
                breakdown=dict(device_ops=[[k[:160], v] for k, v in top],
                               idle_gaps=named))
