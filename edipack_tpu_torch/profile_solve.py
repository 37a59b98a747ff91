"""Device-time profile of one warm config 2 solve on a CUDA card.

    python3 -m edipack_tpu_torch.profile_solve [float64|float32]

Config 2 is the two-orbital Kanamori model (norb=2, nbath=6, uloc=[2,2],
ust=1.2, jh=0.2, jx=0.15, jp=0.15, zero Hloc, default bath), at the
``ed_precision`` given (float64 by default). The script runs one cold
``ed_solve`` without the profiler (it builds the kernels and gives the
unprofiled wall time), then one warm ``ed_solve`` under ``torch.profiler``
with CUDA activity only. It prints the device time by kernel, grouped as
the fused matvec (B1 at f64, B2 at f32: the row-gather kernel's
instantiations for double and float), cuBLAS gemm/gemv (the full
reorthogonalization and Ritz products), host-to-device copies and the
rest, and the device busy and idle shares of the profiled solve. Busy and
idle both come from the one profiled window; the solve runs on one CUDA
stream, so device times add without overlap.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

import edipack_tpu_torch.main as ed
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.device import synchronize
from edipack_tpu_torch.ops import fused_matvec as fm

CONFIG2 = dict(norb=2, nbath=6, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
               jx=0.15, jp=0.15, ed_verbose=0)
TOP = 20


def _group(name: str) -> str:
    if "row_gather_kernel<double" in name:
        return "fused matvec B1 (f64)"
    if "row_gather_kernel<float" in name:
        return "fused matvec B2 (f32)"
    low = name.lower()
    if "gemm" in low or "gemv" in low or "splitk" in low:
        return "cuBLAS gemm/gemv"
    if "htod" in low:
        return "host-to-device copies"
    return "other device work"


def _timed_solve(dev: torch.device, bath):
    synchronize(dev)
    fm.launches = fm.launches_f32 = 0
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    synchronize(dev)
    return res, time.perf_counter() - t0, fm.launches + fm.launches_f32


def profile_solve(cfg, device="cuda") -> dict:
    """Cold solve, then a profiled warm solve; returns the summary and
    prints the kernel table. ``device="cpu"`` rehearses the flow (the
    profiler then records CPU activity and the device time is 0)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(device)
    bath = ed.ed_init_solver(cfg=cfg, device=dev)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    _, cold_s, _ = _timed_solve(dev, bath)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" \
        else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        res, prof_s, launched = _timed_solve(dev, bath)
    ed.ed_finalize_solver()
    rows = sorted(prof.key_averages(),
                  key=lambda r: -r.self_device_time_total)
    groups: dict = {}
    for r in rows:
        g = _group(r.key)
        groups[g] = groups.get(g, 0.0) + r.self_device_time_total * 1e-6
    busy = sum(groups.values())
    print(f"[profile] cold solve {cold_s:.3f} s unprofiled; warm solve "
          f"{prof_s:.3f} s profiled; e0 {res.e0:.12f}, matvecs "
          f"{res.n_matvecs}, B1/B2 launches {launched}")
    print(f"[profile] device busy {busy:.3f} s of the profiled "
          f"{prof_s:.3f} s: busy share {busy / prof_s:.4f}, idle share "
          f"{1 - busy / prof_s:.4f}")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g:24s} {t:10.3f} s  "
              f"{t / busy if busy else 0.0:7.2%} of busy")
    print(f"[profile] top {TOP} device rows (name, calls, seconds):")
    for r in rows[:TOP]:
        print(f"[profile]   {r.count:8d} {r.self_device_time_total * 1e-6:10.3f}"
              f"  {r.key[:100]}")
    return dict(cold_s=cold_s, profiled_s=prof_s, busy_s=busy,
                launches=launched, groups=groups)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve: needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    precision = sys.argv[1] if len(sys.argv) > 1 else "float64"
    profile_solve(default_config(**CONFIG2, ed_precision=precision), "cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
