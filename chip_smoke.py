#!/usr/bin/env python3
"""Smoke run of edipack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, run in this order (each raises on failure; the exit code is
non-zero on any fault):
  build   build the CUDA kernel from csrc/ and print nvcc's register report
  kernel  fused kernel vs its plain PyTorch version at config 2's (7,7)
          sector and the nbath=4 (5,4) sector; CUDA-event times of the
          kernel, the plain version and KronMatvec
  golden  ed_solve at norb=2, nbath=4 through the fused kernel vs the
          edipack_tpu reference numbers in tests/data/
  solve   config 2 (norb=2, nbath=6 Kanamori) through ed_init_solver ->
          ed_set_hloc -> ed_solve on the card, cold and warm, with the
          ground-state sector's e0 re-derived through KronMatvec

The line before the last is the kernel report (JSON), printed only once
every phase has run: ``launches`` is the kernel's launch count in the
cold config 2 solve, ``max_abs_err``, ``ms`` and ``plain_ms`` come from
the kernel phase at the (7,7) and (5,4) shapes. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside the repository,
the script fails before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_n2b4.json")
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
KERNEL_RTOL = 1e-12
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, energies=1e-8, gimp=1e-8,
           sigma=1e-8)
NMATS = 32


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median over ``reps`` launches of one call's time (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sector_op(norb: int, nbath: int, nup: int, ndw: int):
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    cfg = default_config(norb=norb, nbath=nbath, nspin=1, **KANAMORI)
    sec = SectorTable(cfg).by_qn(("n", (nup,), (ndw,)))
    hloc = np.zeros((1, 1, norb, norb))
    return build_normal_sector_op(cfg, sec, hloc, build_umatrix(cfg),
                                  init_bath(cfg))


def phase_build(report: dict) -> None:
    from edipack_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] kernel library {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build]   {line.strip()}")


def phase_kernel(report: dict) -> None:
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    from edipack_tpu_torch.ops.matvec import KronMatvec
    dev = torch.device("cuda")
    for label, (norb, nbath, nup, ndw) in (("(7,7) config 2", (2, 6, 7, 7)),
                                           ("(5,4) nbath=4", (2, 4, 5, 4))):
        op = sector_op(norb, nbath, nup, ndw)
        fop = build_fused_normal(op, norb)
        if fop is None:
            fail(f"{label}: build_fused_normal returned None")
        mv = fm.FusedKron(fop, dev)
        rng = np.random.default_rng(11)
        v_orig = torch.as_tensor(rng.standard_normal(fop.dd * fop.du),
                                 device=dev)
        v3 = mv.to_internal_flat(v_orig).view(-1, 128)   # padding zeroed
        ref = fm.fused_matvec_plain(v3, mv.ops)
        out = fm.fused_matvec(v3, mv.ops)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        # the kernel against the dense-factor operator, through the layout
        kron = KronMatvec(op, dev)
        kref = kron(v_orig)
        rel_k = float((mv.from_internal_flat(out.view(-1)) - kref).abs().max()
                      / kref.abs().max())
        t_k = cuda_ms(lambda: fm.fused_matvec(v3, mv.ops))
        t_p = cuda_ms(lambda: fm.fused_matvec_plain(v3, mv.ops))
        t_x = cuda_ms(lambda: kron(v_orig))
        nnz = fop.nnz
        print(f"[kernel] {label}: dim {fop.dd}x{fop.du} (padded "
              f"{fop.ddp}x{fop.dup}), nnz {nnz:.4e}, up blocks "
              f"{len(fop.up_src)}, dw blocks {len(fop.dw_src)}, runs "
              f"{len(fop.nl_runs)}")
        print(f"[kernel]   kernel vs plain: max_abs_err {err:.3e}, rel "
              f"{rel:.3e} (limit {KERNEL_RTOL}); vs KronMatvec rel {rel_k:.3e}")
        for name, t in (("kernel", t_k), ("plain", t_p), ("KronMatvec", t_x)):
            print(f"[kernel]   {name:10s} {t:9.4f} ms  {nnz / t * 1e-6:8.3f} "
                  f"Gnnz/s")
        if not (rel <= KERNEL_RTOL and rel_k <= KERNEL_RTOL):
            fail(f"{label}: kernel disagrees (rel {rel:.3e}, vs Kron "
                 f"{rel_k:.3e})")
        report.setdefault("shapes", []).append(
            dict(label=label, max_abs_err=err, rel=rel, ms=t_k, plain_ms=t_p,
                 kron_ms=t_x))


def _z(beta: float) -> np.ndarray:
    return 1j * np.pi / beta * (2 * np.arange(NMATS) + 1)


def _check_close(what: str, got, want, tol: float) -> None:
    dev = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"[golden]   {what:9s} max dev {dev:.3e} (limit {tol})")
    if not dev <= tol:
        fail(f"golden {what}: deviation {dev:.3e} > {tol}")


def phase_golden(report: dict) -> None:
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.ops import fused_matvec as fm
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    cfg = default_config(**gold["config"])
    cfg = cfg.replace(ed_fused_matvec="always", ed_verbose=0)
    ed.ed_init_solver(np.asarray(gold["bath"]), cfg=cfg, device="cuda")
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    fm.launches = 0
    res = ed.ed_solve()
    launched = fm.launches
    z = _z(cfg.beta)
    cplx = lambda a: np.asarray(a)[..., 0] + 1j * np.asarray(a)[..., 1]
    print(f"[golden] norb=2 nbath=4 on cuda: e0 {res.e0:.12f} "
          f"(ref {gold['e0']:.12f}), kernel launches {launched}")
    _check_close("e0", res.e0, gold["e0"], TOL["e0"])
    _check_close("evals", ed.ed_get_evals(), gold["evals"], TOL["e0"])
    _check_close("dens", ed.ed_get_dens(), gold["dens"], TOL["dens"])
    _check_close("docc", ed.ed_get_docc(), gold["docc"], TOL["docc"])
    _check_close("energies", ed.ed_get_eimp(), gold["energies"],
                 TOL["energies"])
    _check_close("gimp", ed.ed_get_gimp(z), cplx(gold["gimp"]), TOL["gimp"])
    _check_close("sigma", ed.ed_get_sigma(z), cplx(gold["sigma"]),
                 TOL["sigma"])
    if launched <= 0:
        fail("golden solve did not launch the fused kernel")
    ed.ed_finalize_solver()


def _solve_once(label: str, cfg, bath):
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.ops import fused_matvec as fm
    import torch
    torch.cuda.synchronize()
    fm.launches = 0
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = fm.launches
    z = _z(cfg.beta)
    g = ed.ed_get_gimp(z)
    s = ed.ed_get_sigma(z)
    dens, docc, en = ed.ed_get_dens(), ed.ed_get_docc(), ed.ed_get_eimp()
    print(f"[solve] {label}: wall {wall:.2f} s, phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res.timings.items()))
    print(f"[solve]   e0 {res.e0:.12f}  states {len(res.evals)}  matvecs "
          f"{res.n_matvecs}  kernel launches {launched}")
    print(f"[solve]   dens {np.array2string(dens, precision=10)}  docc "
          f"{np.array2string(docc, precision=10)}")
    print(f"[solve]   energies {np.array2string(en, precision=10)}")
    print(f"[solve]   G(iw0) {g[0, 0, :, :, 0].ravel()}  Sigma(iw0) "
          f"{s[0, 0, :, :, 0].ravel()}")
    for name, arr, shape in (("gimp", g, (1, 1, 2, 2, NMATS)),
                             ("sigma", s, (1, 1, 2, 2, NMATS)),
                             ("dens", dens, (2,)), ("docc", docc, (2,)),
                             ("energies", en, (4,))):
        if arr.shape != shape or not np.all(np.isfinite(arr)):
            fail(f"{label}: {name} has shape {arr.shape} or is not finite")
    if not 0.0 < dens.sum() < 4.0:
        fail(f"{label}: unphysical density {dens}")
    return res, launched, wall


def phase_solve(report: dict) -> None:
    import torch
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.ops.matvec import KronMatvec
    cfg = default_config(norb=2, nbath=6, nspin=1, ed_verbose=3, **KANAMORI)
    bath = ed.ed_init_solver(cfg=cfg, device="cuda")
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    torch.cuda.reset_peak_memory_stats()
    res, launched, wall = _solve_once("config 2 cold", cfg, bath)
    report["launches"] = launched
    report["cold"] = dict(wall_s=wall, matvecs=res.n_matvecs, **res.timings)
    if launched <= 0:
        fail("config 2 solve did not launch the fused kernel")
    res2, launched2, wall2 = _solve_once("config 2 warm", cfg, bath)
    report["warm"] = dict(wall_s=wall2, matvecs=res2.n_matvecs,
                          launches=launched2, **res2.timings)
    print(f"[solve]   peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # ground-state sector re-solved through the dense-factor KronMatvec
    st = res.diag.state_list.states[0]
    sec = res.table.sector(st.sector)
    mv = KronMatvec(build_normal_sector_op(cfg, sec, res.hloc, res.um,
                                           res.bath), torch.device("cuda"))
    vals, _ = eigsh_lowest(mv, mv.dim, 1, tol=1e-14)
    dev = abs(float(vals[0]) - res.e0)
    print(f"[solve] ground-state sector {sec.qn} dim {sec.dim}: KronMatvec "
          f"e0 {vals[0]:.12f}, solve e0 {res.e0:.12f}, |diff| {dev:.3e}")
    if not dev <= 1e-10:
        fail(f"ground-state e0 disagrees with KronMatvec ({dev:.3e})")
    ed.ed_finalize_solver()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import edipack_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())          # name, power limit, as nvidia-smi gives them
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report: dict = {}
    for name, fn in (("build", phase_build), ("kernel", phase_kernel),
                     ("golden", phase_golden), ("solve", phase_solve)):
        t0 = time.perf_counter()
        fn(report)
        print(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    big = report["shapes"][0]          # config 2's (7,7) sector
    kern = dict(name="fused_normal_matvec_f64", route="cuda",
                source="edipack_tpu_torch/csrc/fused_normal.cu",
                replaces="edipack_tpu/ops/pallas_fused.py:237",
                launches=report["launches"],
                max_abs_err=max(s["max_abs_err"] for s in report["shapes"]),
                ms=big["ms"], plain_ms=big["plain_ms"])
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
