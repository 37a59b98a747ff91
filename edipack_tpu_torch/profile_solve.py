"""Device-time profile of one warm solve on a CUDA card.

    python3 -m edipack_tpu_torch.profile_solve [float64|float32|config3|config4]

``float64`` (the default) and ``float32``: config 2, the two-orbital
Kanamori model (norb=2, nbath=6, uloc=[2,2], ust=1.2, jh=0.2, jx=0.15,
jp=0.15, zero Hloc, default bath), at that ``ed_precision``. ``config3``:
BASELINE config 3, superc (norb=2, nbath=4, uloc=[-2,-2], ust=-1,
jh=jx=jp=0.25, deltasc=0.02, zero Hloc); ``config4``: config 4, nonsu2
(norb=2, nbath=3, uloc=[2,2], ust=1.2, jh=0.25, spin_field_x=0.1, the
±0.1i spin-mixing Hloc); both on the padded-ELL route with six levels a
sector, as chip_smoke.py solves them. The script runs one cold
``ed_solve`` without the profiler (it builds the kernels and gives the
unprofiled wall time), then one warm ``ed_solve`` under ``torch.profiler``
with CUDA activity only. It prints the device time by kernel, grouped as
the fused matvec (B1 at f64, B2 at f32: the row-gather kernel's
instantiations for double and float), cuBLAS gemm/gemv (the full
reorthogonalization and Ritz products), gathers and scatters (the joint
operators' index_select / index_add / gather), reductions,
host-to-device copies and the rest, and the device busy and idle shares
of the profiled solve. Busy and idle both come from the one profiled
window; the solve runs on one CUDA stream, so device times add without
overlap.
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
CONFIG3 = dict(norb=2, nbath=4, nspin=1, ed_mode="superc", uloc=[-2.0, -2.0],
               ust=-1.0, jh=0.25, jx=0.25, jp=0.25, deltasc=0.02)
CONFIG4 = dict(norb=2, nbath=3, nspin=2, ed_mode="nonsu2", uloc=[2.0, 2.0],
               ust=1.2, jh=0.25, spin_field_x=[0.1, 0.1])
# levels asked of each sector of configs 3 and 4: the two orbitals are
# alike, so the ground multiplets are degenerate; every sector that holds
# kept states must also have found a level above the T=0 window (a
# complete multiplet: G of an incomplete one depends on which members
# Lanczos found)
JOINT_NEV = 6
TOP = 20


def spin_mixing_hloc(norb: int) -> np.ndarray:
    """bench.py's SOC-like Hloc of config 4: ±0.1i between the spins."""
    h = np.zeros((2, 2, norb, norb), complex)
    h[0, 1] = 0.1j * np.eye(norb)
    h[1, 0] = -0.1j * np.eye(norb)
    return h


def problem(name: str):
    """(config, Hloc) of a command-line name."""
    if name in ("float64", "float32"):
        return default_config(**CONFIG2, ed_precision=name), \
            np.zeros((1, 1, 2, 2))
    joint = dict(lanc_nstates_sector=JOINT_NEV, ed_verbose=0)
    if name == "config3":
        return default_config(**CONFIG3, **joint), np.zeros((1, 1, 2, 2))
    if name == "config4":
        return default_config(**CONFIG4, **joint), spin_mixing_hloc(2)
    raise SystemExit(f"profile_solve: unknown problem {name!r}; one of "
                     f"float64, float32, config3, config4")


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
    if "index" in low or "gather" in low or "scatter" in low:
        return "gathers and scatters"
    if "reduce" in low:
        return "reductions"
    return "other device work"


def _timed_solve(dev: torch.device, bath):
    synchronize(dev)
    fm.launches = fm.launches_f32 = 0
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    synchronize(dev)
    return res, time.perf_counter() - t0, fm.launches + fm.launches_f32


def profile_solve(cfg, device="cuda", hloc=None) -> dict:
    """Cold solve, then a profiled warm solve; returns the summary and
    prints the kernel table. ``hloc``: zero if not given. ``device="cpu"``
    rehearses the flow (the profiler then records CPU activity and the
    device time is 0)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(device)
    bath = ed.ed_init_solver(cfg=cfg, device=dev)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)) if hloc is None
                   else hloc)
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
    print(f"[profile] {cfg.ed_mode} norb={cfg.norb} nbath={cfg.nbath} "
          f"{cfg.ed_precision}: cold solve {cold_s:.3f} s unprofiled; warm "
          f"solve {prof_s:.3f} s profiled, phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items())
          + f"; e0 {res.e0:.12f}, matvecs {res.n_matvecs}, B1/B2 launches "
          f"{launched}")
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
    cfg, hloc = problem(sys.argv[1] if len(sys.argv) > 1 else "float64")
    profile_solve(cfg, "cuda", hloc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
