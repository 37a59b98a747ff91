#!/usr/bin/env python3
"""Smoke run of edipack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, run in this order (each raises on failure; the exit code is
non-zero on any fault):
  build   build the CUDA kernels from csrc/ (one nvcc per source, started
          together) and print nvcc's register report of each kernel
  kernel  every kernel against its plain PyTorch version, with CUDA-event
          times of both and of the PyTorch yardsticks (cuSPARSE CSR factors
          for all four, dense GEMMs for B4 too), each timed twice: with the
          50 MB L2 flushed before every launch (a 128 MB scratch write; the
          report's times) and back to back:
          B1 (f64) and B2 (f32), the sparse row-gather fused matvec, at
          config 2's (7,7) sector, the nbath=4 (5,4) sector and the
          nbath=7 (6,1) sector (8008 up states: 3 rows a block in f64, 7
          in f32, so the last of its 128 padded rows' blocks is short), B2
          also against B1; B3 (chained f32 power steps) at (7,7) and
          (6,1), niter=8 against the plain loop, then the
          power-step entry at niter=100, timed per step; B4 (f32 sparse
          row-gather Kron) at (7,7) and the nbath=2 (3,2) sector, against
          its plain version, the dense formula and f32 KronMatvec
  golden  ed_solve at norb=2, nbath=4 through the fused kernels, f64 (B1)
          and f32 (B2, twin sectors on), vs the edipack_tpu reference
          numbers in tests/data/ (the f32 solve also vs the f64 numbers of
          the same configuration in that file)
  solve   config 2 (norb=2, nbath=6 Kanamori) through ed_init_solver ->
          ed_set_hloc -> ed_solve on the card, cold, in f64 (B1) and in f32
          (B2); the f64 ground-state sector's e0 re-derived through
          KronMatvec; the (7,7) sector's lowest level through Lanczos on the
          row-gather Kron operator (B4) against the f64 solve's; the
          states the f32 solve keeps against those the f64 solve keeps
          (as many in each sector, none a copy of another, each energy
          within E0_F32_RTOL), and its G (on the BETA_GRID frequencies),
          densities, double occupancies and energies against the f64
          solve's at TOL_F32_EXACT
  dmft    the DMFT loop on the card: (a) two Bethe-lattice iterations
          (solve, Δ = (D/2)² G, ed_chi2_fitgf) at norb=2, nbath=4 through
          B1, held to tests/data/torch_port_golden_dmft_n2b4.json; (b) config
          2's second iteration: the bath fitted to Δ of the f64 solve above
          (its first iteration), the restart files written, a new solver
          started from hamiltonian.restart and state_list.restart, and its
          ed_solve through B1 with ed_write_files on, checked like the first
  extras  the normal-mode extras through B1, in f64: (a) the n2b4 extras
          golden (tests/data/torch_port_golden_extras_n2b4.json, from
          edipack_tpu): a T=0 solve with the four χ flags and rdm_flag (χ
          on ν_1..ν_32 of β = 20, RDM, a reduced RDM, energies, sp_dm) and
          its Krylov
          state complexity; three finite-T solves of one solver (budgets
          and neigen_sector exact, zeta, e0, dens, G, histogram_states.ed
          as text); an ed_total_ud=False solve; a runtime two-body term;
          each with B1 launches > 0; (b) config 2 cold with the χ flags and
          rdm_flag, then ed_build_krylov_state_complexity, held by
          identities B1 does not enter: each χ channel's + weights sum to
          Σ_i w_i ‖Oψ_i‖² (and, for spin and dens, to (n - 2d)/4 and n + 2d
          of the solve's dens and docc), the first moments of the spin and
          pair channels of orbital 0 against KronMatvec, the RDM's trace,
          Hermiticity, eigenvalues and diagonal, and the Krylov
          distributions' normalization and K(0) = 0

Each kernel's path (the f64 solve for B1, the f32 solve for B2, the
power-step entry for B3, the row-gather Lanczos for B4, and for B1 also
config 2's second DMFT iteration, the extras golden's solves and Krylov
chains, and config 2's extras solve with its Krylov chains) runs with
every launch counter set to 0 just before it and read just after. The line before
the last is the kernel report (JSON), printed only once every phase has
run: ``launches`` from those paths, ``max_abs_err``, ``ms`` (L2 flushed),
``ms_back_to_back``, ``plain_ms`` and ``library_ms`` (the faster of the
yardsticks, named by ``library_call``) from the kernel phase at config 2's
(7,7) sector (B3: per power step), ``bound_ms`` computed from those inputs:
the function's work on this data (two operations per nonzero of the
sector's H) against its bytes (V, the output and the ELL tables the
kernel reads). B3's ``launches``
counts kernel launches, two per power step. The last line is
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
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_port_golden_n2b4.json")
GOLDEN_F32 = os.path.join(DATA, "torch_port_golden_f32_n2b4.json")
GOLDEN_DMFT = os.path.join(DATA, "torch_port_golden_dmft_n2b4.json")
GOLDEN_EXTRAS = os.path.join(DATA, "torch_port_golden_extras_n2b4.json")
KANAMORI = dict(uloc=[2.0, 2.0], ust=1.2, jh=0.2, jx=0.15, jp=0.15)
# tests/test_pallas_kron.py's sector model
KRON_SMALL = dict(uloc=[2.0, 1.5], ust=0.7, jh=0.1, jx=0.1, jp=0.1, xmu=0.2)
KERNEL_RTOL = 1e-12       # B1 vs its plain version (f64, other sum order)
F32_RTOL = 3e-6           # B2 vs plain and vs B1 (tests/test_fused.py:53)
POWER_TOL = 1e-5          # B3 norms and final vector (tests/test_fused.py)
KRON_RTOL = 1e-5          # B4 at (7,7)
KRON_ATOL = 1e-4          # B4 at (3,2) (tests/test_pallas_kron.py:37)
TOL = dict(e0=1e-10, dens=1e-8, docc=1e-8, energies=1e-8, gimp=1e-8,
           sigma=1e-8)
# f32 golden: against the same configuration's f64 solve (the file's "f64"
# numbers), e0 and evals 3e-5, dens, docc and energies 1e-5, G 1e-4, Σ 1e-3;
# against edipack_tpu's f32 solve the same, except e0, evals and G at 3x
# that solve's own distance from f64 (e0 1.11e-4: the Ritz value of its f32
# recurrence; G 8.0e-5)
TOL_F32_EXACT = dict(e0=3e-5, dens=1e-5, docc=1e-5, energies=1e-5, gimp=1e-4,
                     sigma=1e-3)
TOL_F32 = dict(TOL_F32_EXACT, e0=3.3e-4, gimp=2.4e-4)
E0_F32_RTOL = 1e-5        # config 2: f32 e0 vs f64 e0, relative
# the DMFT golden: loop 1 at TOL; the fitted baths and loop 2 at
# TOL_DMFT, tests/test_torch_dmft.py's GOLDEN_TOL (it states the gaps of
# the port's loops on the CPU that set it)
TOL_DMFT = dict(e0=1e-7, dens=1e-7, docc=1e-7, gimp=1e-7, sigma=1e-5,
                bath=1e-7)
WBAND = 1.0               # Bethe lattice half-bandwidth D
# the extras golden: f64 on both sides, the solve golden's TOL; χ relative
# to its largest value; budgets and neigen_sector exact
TOL_EXTRAS = dict(TOL, chi=1e-8, sp_dm=1e-8, rdm=1e-8, krylov=1e-8,
                  zeta=1e-10)
# config 2 with the extras on: identities that B1 does not enter
IDENTITY_RTOL = 1e-8      # χ sum rules and first moments, RDM vs dens/docc
RDM_TOL = 1e-10           # RDM trace, Hermiticity, eigenvalues >= -RDM_TOL
CHI_FLAGS = dict(chispin_flag=True, chidens_flag=True, chipair_flag=True,
                 chiexct_flag=True, rdm_flag=True)
# Matsubara grid on which config 2's f32 G is held to its f64 G at
# TOL_F32_EXACT, as the f32 golden file's (tests/test_torch_f32.py): on the
# solve's own grid (beta = 1000) the lowest frequencies magnify the f32
# error of the low excitation energies
BETA_GRID = 20.0
NMATS = 32
DEVICE = "cuda"
POWER_NITER = 100
# kept states of one sector: a copy overlaps its original by 1
KEPT_OVERLAP = 1e-3
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP64 tensor core and FP32
# 67 TFLOP/s, HBM3 3.35 TB/s
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops import kron_tiles as kt
    fm.launches = fm.launches_f32 = fm.power_launches = 0
    kt.launches = 0


def read_counts() -> dict:
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops import kron_tiles as kt
    return dict(B1=fm.launches, B2=fm.launches_f32, B3=fm.power_launches,
                B4=kt.launches)


_SCRATCH = []


def flush_l2() -> None:
    """Evict the 50 MB L2: write a 128 MB scratch tensor."""
    import torch
    if not _SCRATCH:
        _SCRATCH.append(torch.empty(32 * 2**20, dtype=torch.float32,
                                    device=DEVICE))
    _SCRATCH[0].fill_(1.0)


def cuda_ms(fn, reps: int = 25, warm: int = 3, flush: bool = False
            ) -> float:
    """Median over ``reps`` launches of one call's time (CUDA events);
    with ``flush`` the L2 is flushed before each launch, outside the
    events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush:
            flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timed(times: dict, name: str, fn, reps: int = 25) -> None:
    """times[name]: the L2 flushed before each launch; times[name +
    "_b2b"]: back to back."""
    times[name] = cuda_ms(fn, reps=reps, flush=True)
    times[name + "_b2b"] = cuda_ms(fn, reps=reps)


def bound(flops: float, nbytes: float, kind: str) -> dict:
    """The least time of the work on the card: the larger of its
    operations over the peak rate and its bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes",
                gflop=flops * 1e-9, mbytes=nbytes * 1e-6)


def fused_bound(fop, kind: str, extra_flops: float = 0.0) -> dict:
    """One fused matvec of this sector as the function it computes: two
    operations per nonzero of H (``fop.nnz``: the diagonal, both hop
    factors and the Jx/Jp terms) and the diagonal's rank-8 products; V3
    read once, W3 written once, the diagonal factors, the runs and the ELL
    tables of the hop factors read once."""
    from edipack_tpu_torch.ops.fused_normal import DIAG_RANK
    es = 8 if kind == "f64" else 4
    n = fop.ddp * fop.dup
    flops = 2 * fop.nnz + 2 * DIAG_RANK * fop.dd * fop.du + extra_flops
    nbytes = (es * (2 * n + (fop.ddp + fop.dup) * DIAG_RANK)
              + (es + 4) * (fop.up_ell_idx.size + fop.dw_ell_idx.size)
              + (4 * 6 + es) * len(fop.nl_runs))
    return bound(flops, nbytes, kind)


def kron_bound(mv) -> dict:
    """One Kron matvec as the function it computes: two operations per
    nonzero of Hup for each row of V and per nonzero of Hdw for each
    column, and D⊙V with the two sums; V and D read once, the output
    written once, the ELL tables read once."""
    import torch
    n = mv.dd * mv.du
    flops = (2 * (int(torch.count_nonzero(mv.up_val)) * mv.dd
                  + int(torch.count_nonzero(mv.dw_val)) * mv.du) + 3 * n)
    nbytes = 4 * 3 * n + 8 * (mv.up_idx.numel() + mv.dw_idx.numel())
    return bound(flops, nbytes, "f32")


def csr_yardstick(op, dtype):
    """One set of PyTorch calls computing D⊙V + Hdw·V + V·Hupᵀ on the 2-D
    (dd, du) layout in the original basis order, with the hop factors as
    cuSPARSE CSR tensors (the Jx/Jp terms left out). Returns (fn, V)."""
    import torch
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                    device=DEVICE)
    hup, hdw = put(op.hup).to_sparse_csr(), put(op.hdw).to_sparse_csr()
    dd, du = op.hdw.shape[0], op.hup.shape[0]
    d = put(np.asarray(op.d).reshape(dd, du))
    v = put(np.random.default_rng(13).standard_normal((dd, du)))
    return (lambda x: d * x + torch.sparse.mm(hdw, x)
            + torch.sparse.mm(hup, x.T).T), v


def sector_op(norb: int, nbath: int, nup: int, ndw: int, model=None,
              hloc=None):
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    cfg = default_config(norb=norb, nbath=nbath, nspin=1,
                         **(model or KANAMORI))
    sec = SectorTable(cfg).by_qn(("n", (nup,), (ndw,)))
    h = np.zeros((1, 1, norb, norb))
    if hloc is not None:
        h[0, 0] = hloc
    return build_normal_sector_op(cfg, sec, h, build_umatrix(cfg),
                                  init_bath(cfg))


def _rel(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def phase_build(report: dict) -> None:
    from edipack_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] kernel library {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} "
          f"s, {len(_build.SOURCES)} sources)")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error")):
            print(f"[build]   {line.strip()}")


def _fused_shape(report: dict, label: str, op, norb: int) -> None:
    """B1 and B2 at one sector's shape."""
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    from edipack_tpu_torch.ops.matvec import KronMatvec
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    fop = build_fused_normal(op, norb)
    host_s = time.perf_counter() - t0
    if fop is None:
        fail(f"{label}: build_fused_normal returned None")
    mv64 = fm.FusedKron(fop, dev)
    mv32 = fm.FusedKron(fop, dev, dtype=torch.float32)
    rng = np.random.default_rng(11)
    v_orig = torch.as_tensor(rng.standard_normal(fop.dd * fop.du), device=dev)
    v64 = mv64.to_internal_flat(v_orig).view(-1, 128)    # padding zeroed
    v32 = v64.float()
    print(f"[kernel] {label}: dim {fop.dd}x{fop.du} (padded "
          f"{fop.ddp}x{fop.dup}), nnz {fop.nnz:.4e}, ELL widths up "
          f"{fop.up_ell_idx.shape[0]} dw {fop.dw_ell_idx.shape[0]}, runs "
          f"{len(fop.nl_runs)}; host build_fused_normal {host_s:.3f} s")
    # B1 against its plain version and the dense-factor operator
    out64 = fm.fused_matvec(v64, mv64.ops)
    ref64 = fm.fused_matvec_plain(v64, mv64.ops)
    kron64 = KronMatvec(op, dev)
    kref = kron64(v_orig)
    torch.cuda.synchronize()
    err64 = float((out64 - ref64).abs().max())
    rel64 = _rel(out64, ref64)
    rel_k = _rel(mv64.from_internal_flat(out64.view(-1)), kref)
    # B2 against its plain version and against B1's f64 product
    out32 = fm.fused_matvec(v32, mv32.ops)
    ref32 = fm.fused_matvec_plain(v32, mv32.ops)
    torch.cuda.synchronize()
    err32 = float((out32 - ref32).abs().max())
    rel32 = _rel(out32, ref32)
    rel32_b1 = _rel(out32.double(), out64)
    kron32 = KronMatvec(op, dev, dtype=torch.float32)
    v_orig32 = v_orig.float()
    lib64, x64 = csr_yardstick(op, torch.float64)
    lib32, x32 = csr_yardstick(op, torch.float32)
    times: dict = {}
    timed(times, "b1", lambda: fm.fused_matvec(v64, mv64.ops))
    timed(times, "b1_plain", lambda: fm.fused_matvec_plain(v64, mv64.ops))
    timed(times, "b1_csr", lambda: lib64(x64))
    timed(times, "kron64", lambda: kron64(v_orig))
    timed(times, "b2", lambda: fm.fused_matvec(v32, mv32.ops))
    timed(times, "b2_plain", lambda: fm.fused_matvec_plain(v32, mv32.ops))
    timed(times, "b2_csr", lambda: lib32(x32))
    timed(times, "kron32", lambda: kron32(v_orig32))
    b1b = fused_bound(fop, "f64")
    b2b = fused_bound(fop, "f32")
    print(f"[kernel]   B1 vs plain: "
          f"max_abs_err {err64:.3e}, rel {rel64:.3e} (limit {KERNEL_RTOL}); "
          f"vs KronMatvec rel {rel_k:.3e}")
    print(f"[kernel]   B2 vs plain: max_abs_err {err32:.3e}, rel {rel32:.3e}; "
          f"vs B1 rel {rel32_b1:.3e} (limit {F32_RTOL})")
    print("[kernel]   name       flushed ms  back-to-back ms  Gnnz/s "
          "(b1_csr, b2_csr: cuSPARSE CSR, Jx/Jp terms left out)")
    for name in [k for k in times if not k.endswith("_b2b")]:
        t, t2 = times[name], times[name + "_b2b"]
        print(f"[kernel]   {name:9s} {t:11.4f} {t2:16.4f}  "
              f"{fop.nnz / t * 1e-6:8.3f}")
    print(f"[kernel]   bound: B1 {b1b['bound_ms']:.4f} ms ({b1b['bound_by']}, "
          f"{b1b['gflop']:.3f} GFLOP, {b1b['mbytes']:.1f} MB), B2 "
          f"{b2b['bound_ms']:.4f} ms ({b2b['bound_by']}, {b2b['mbytes']:.1f} "
          f"MB), with the ELL tables")
    if not (rel64 <= KERNEL_RTOL and rel_k <= KERNEL_RTOL):
        fail(f"{label}: B1 disagrees (rel {rel64:.3e}, vs Kron {rel_k:.3e})")
    if not (rel32 <= F32_RTOL and rel32_b1 <= F32_RTOL):
        fail(f"{label}: B2 disagrees (rel {rel32:.3e}, vs B1 "
             f"{rel32_b1:.3e})")
    report.setdefault("fused", []).append(dict(
        label=label, fop=fop, err64=err64, err32=err32, bound64=b1b,
        bound32=b2b, **times))


def _power_vector(fop):
    """A padded f32 start vector on the sector's column-blocked layout."""
    import torch
    v = np.random.default_rng(0).standard_normal(
        (fop.ddp, fop.dup)).astype(np.float32)
    v[fop.dd:, :] = 0
    v[:, fop.du:] = 0
    return torch.as_tensor(fop.to_blocked(v), device=DEVICE)


def _power_check(label: str, fop) -> list:
    """B3 at one sector, niter=8, against the plain loop: the norms and the
    final normalized vector. Returns the absolute errors."""
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    v3 = _power_vector(fop)
    ops = fm.FusedOperands(fop, torch.device(DEVICE), torch.float32)
    w_ref, n_ref = fm.fused_power_plain(v3, ops, 8)
    unit = lambda w: w / torch.linalg.norm(w)
    w3, norms = fm.fused_power(v3, ops, 8)
    torch.cuda.synchronize()
    rel_n = float(((norms - n_ref).abs() / n_ref).max())
    err_v = float((unit(w3) - unit(w_ref)).abs().max())
    print(f"[kernel] B3 {label} niter=8: norms rel {rel_n:.3e}, final vector "
          f"{err_v:.3e} (limit {POWER_TOL}); norms {norms[:3].tolist()} ...")
    if not (rel_n <= POWER_TOL and err_v <= POWER_TOL):
        fail(f"B3 {label} disagrees (norms {rel_n:.3e}, vector "
             f"{err_v:.3e})")
    return [float((w3 - w_ref).abs().max()),
            float((norms - n_ref).abs().max())]


def _power(report: dict, fop, op, wide) -> None:
    """B3 against the plain loop at config 2's (7,7) and at the wide
    sector ``wide`` (a short last row block), then the power-step entry
    (bench.py's niter=100) at (7,7) timed per step."""
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    dev = torch.device(DEVICE)
    errs = _power_check("(7,7) config 2", fop) \
        + _power_check("(6,1) nbath=7", wide)
    v3 = _power_vector(fop)
    ops = fm.FusedOperands(fop, dev, torch.float32)
    plain_step = cuda_ms(lambda: fm.fused_power_plain(v3, ops, 8), reps=5,
                         flush=True) / 8
    lib, x = csr_yardstick(op, torch.float32)

    def lib_step():
        w = lib(x)
        return w / torch.linalg.vector_norm(w)

    lib_ms: dict = {}
    timed(lib_ms, "csr", lib_step)
    # the power-step entry, as bench.py drives it
    power = fm.FusedPower(fop, POWER_NITER, dev)
    power(v3)
    torch.cuda.synchronize()
    reset_counts()
    step_b2b = cuda_ms(lambda: power(v3), reps=3, warm=0) / POWER_NITER
    counts = read_counts()
    step = cuda_ms(lambda: power(v3), reps=3, warm=0, flush=True) / POWER_NITER
    b = fused_bound(fop, "f32", extra_flops=3 * fop.ddp * fop.dup)
    print(f"[kernel] B3 power-step entry, niter={POWER_NITER}: {step:.4f} ms "
          f"per step flushed before each call, {step_b2b:.4f} ms back to back "
          f"({fop.nnz / step * 1e-6:.3f} Gnnz/s), plain {plain_step:.4f} ms "
          f"per step, cuSPARSE CSR step with norm and scale "
          f"{lib_ms['csr']:.4f} / {lib_ms['csr_b2b']:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); launches {counts}")
    if counts["B3"] <= 0:
        fail("the power-step entry did not launch B3")
    report["power"] = dict(err=max(errs),
                           ms=step, ms_b2b=step_b2b, plain_ms=plain_step,
                           csr=lib_ms["csr"], bound=b, launches=counts["B3"])


def _kron_tiles(report: dict, label: str, op, strict_rel: bool) -> None:
    """B4 at one sector's shape."""
    import torch
    from edipack_tpu_torch.ops import kron_tiles as kt
    from edipack_tpu_torch.ops.fused_matvec import ell_matvec_plain
    from edipack_tpu_torch.ops.matvec import KronMatvec
    dev = torch.device(DEVICE)
    mv = kt.KronTileMatvec(op, dev)
    rng = np.random.default_rng(12)
    v = torch.as_tensor(rng.standard_normal(mv.dim).astype(np.float32),
                        device=dev)
    v2 = v.view(mv.dd, mv.du)
    hup_t = torch.as_tensor(np.asarray(op.hup).T, dtype=torch.float32,
                            device=dev).contiguous()
    hdw = torch.as_tensor(np.asarray(op.hdw), dtype=torch.float32, device=dev)
    out = kt.kron_matvec_tiles(v2, *mv.tables())
    ref = ell_matvec_plain(v2, *mv.tables())
    dense = kt.kron_matvec_tiles_plain(v2, mv.d, hup_t, hdw)
    kron32 = KronMatvec(op, dev, dtype=torch.float32)
    kref = kron32(v)
    got = mv(v)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = _rel(out, ref)
    err_d = float((out - dense).abs().max())
    rel_d = _rel(out, dense)
    err_k = float((got - kref).abs().max())
    rel_k = _rel(got, kref)
    lib, x = csr_yardstick(op, torch.float32)
    times: dict = {}
    timed(times, "b4", lambda: kt.kron_matvec_tiles(v2, *mv.tables()))
    timed(times, "b4_plain", lambda: ell_matvec_plain(v2, *mv.tables()))
    timed(times, "csr", lambda: lib(x))
    timed(times, "gemm", lambda: v2 @ hup_t + hdw @ v2)
    timed(times, "operator", lambda: mv(v))
    timed(times, "kron32", lambda: kron32(v))
    b = kron_bound(mv)
    print(f"[kernel] B4 {label}: {mv.dd}x{mv.du}, ELL widths up "
          f"{mv.up_idx.shape[0]} dw {mv.dw_idx.shape[0]}; vs plain max_abs_err "
          f"{err:.3e} rel {rel:.3e}; vs "
          f"the dense formula max_abs_err {err_d:.3e} rel {rel_d:.3e}; "
          f"operator vs f32 KronMatvec max_abs_err {err_k:.3e} rel "
          f"{rel_k:.3e}")
    print("[kernel]   name       flushed ms  back-to-back ms (csr: cuSPARSE "
          "CSR factors; gemm: V@Hupᵀ + Hdw@V, dense)")
    for name in [k for k in times if not k.endswith("_b2b")]:
        print(f"[kernel]   {name:9s} {times[name]:11.4f} "
              f"{times[name + '_b2b']:16.4f}")
    print(f"[kernel]   bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
          f"{b['gflop']:.3f} GFLOP, {b['mbytes']:.1f} MB with the ELL "
          f"tables)")
    ok = (max(rel, rel_d, rel_k) <= KRON_RTOL) if strict_rel \
        else (max(err, err_d, err_k) <= KRON_ATOL)
    if not ok:
        fail(f"B4 {label} disagrees (rel {rel:.3e} / {rel_d:.3e} / "
             f"{rel_k:.3e}, abs {err:.3e} / {err_d:.3e} / {err_k:.3e})")
    report.setdefault("kron", []).append(dict(label=label, err=err, bound=b,
                                              **times))


def phase_kernel(report: dict) -> None:
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    op77 = sector_op(2, 6, 7, 7)
    op61 = sector_op(2, 7, 6, 1)
    _fused_shape(report, "(7,7) config 2", op77, 2)
    _fused_shape(report, "(5,4) nbath=4", sector_op(2, 4, 5, 4), 2)
    _fused_shape(report, "(6,1) nbath=7", op61, 2)
    _power(report, build_fused_normal(op77, 2), op77,
           build_fused_normal(op61, 2))
    _kron_tiles(report, "(7,7) config 2", op77, strict_rel=True)
    _kron_tiles(report, "(3,2) nbath=2",
                sector_op(2, 2, 3, 2, KRON_SMALL,
                          np.array([[0.1, 0.04], [0.04, -0.1]])),
                strict_rel=False)


def _z(beta: float) -> np.ndarray:
    return 1j * np.pi / beta * (2 * np.arange(NMATS) + 1)


def _cplx(a) -> np.ndarray:
    """(..., 2) [re, im] pairs of a golden file -> complex."""
    return np.asarray(a)[..., 0] + 1j * np.asarray(a)[..., 1]


def _check_close(what: str, got, want, tol: float) -> None:
    if np.shape(got) != np.shape(want):
        fail(f"golden {what}: shape {np.shape(got)}, expected "
             f"{np.shape(want)}")
    dev = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"[golden]   {what:13s} max dev {dev:.3e} (limit {tol})")
    if not dev <= tol:
        fail(f"golden {what}: deviation {dev:.3e} > {tol}")


def _check_all(got: dict, ref: dict, tol: dict, tag: str = "") -> None:
    for k in ("e0", "evals", "dens", "docc", "energies", "gimp", "sigma"):
        want = _cplx(ref[k]) if k in ("gimp", "sigma") else ref[k]
        _check_close(k + tag, got[k], want, tol["e0" if k == "evals" else k])


def _golden(path: str, tol: dict, kernel: str, tol_f64=None) -> None:
    """ed_solve of the golden file's configuration through ``kernel``,
    held to the file's numbers at ``tol`` and, with ``tol_f64``, to its
    "f64" numbers (the same configuration solved in f64)."""
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    with open(path) as fh:
        gold = json.load(fh)
    cfg = default_config(**gold["config"])
    cfg = cfg.replace(ed_fused_matvec="always", ed_verbose=0)
    ed.ed_init_solver(np.asarray(gold["bath"]), cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    reset_counts()
    res = ed.ed_solve()
    launched = read_counts()[kernel]
    z = _z(gold.get("beta_grid", cfg.beta))
    got = dict(e0=res.e0, evals=ed.ed_get_evals(), dens=ed.ed_get_dens(),
               docc=ed.ed_get_docc(), energies=ed.ed_get_eimp(),
               gimp=ed.ed_get_gimp(z), sigma=ed.ed_get_sigma(z))
    print(f"[golden] norb=2 nbath=4 {cfg.ed_precision} on cuda: e0 "
          f"{res.e0:.12f} (ref {gold['e0']:.12f}), {kernel} launches "
          f"{launched}")
    _check_all(got, gold, tol)
    if tol_f64 is not None:
        _check_all(got, gold["f64"], tol_f64, " vs f64")
    if launched <= 0:
        fail(f"golden {cfg.ed_precision} solve did not launch {kernel}")
    ed.ed_finalize_solver()


def phase_golden(report: dict) -> None:
    _golden(GOLDEN, TOL, "B1")
    _golden(GOLDEN_F32, TOL_F32, "B2", tol_f64=TOL_F32_EXACT)


def _solve_once(label: str, cfg, bath):
    import edipack_tpu_torch.main as ed
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    z = _z(cfg.beta)
    g = ed.ed_get_gimp(z)
    s = ed.ed_get_sigma(z)
    dens, docc, en = ed.ed_get_dens(), ed.ed_get_docc(), ed.ed_get_eimp()
    print(f"[solve] {label}: wall {wall:.2f} s, phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res.timings.items()))
    stats = res.diag.lanczos_stats.values()
    kept = [(res.table.sector(st.sector).qn[1:], f"{st.energy - res.e0:.3e}")
            for st in res.diag.state_list.states]
    print(f"[solve]   e0 {res.e0:.12f}  states {len(res.evals)} (sector, "
          f"E - e0): {kept}  matvecs {res.n_matvecs}  kernel launches "
          f"{counts}")
    near = [(res.table.sector(i).qn[1:], [f"{e - res.e0:.3e}" for e in ev
                                          if e - res.e0 <= 1e-3])
            for i, ev in sorted(res.diag.evals_by_sector.items())]
    print(f"[solve]   levels within 1e-3 of e0: "
          f"{[n for n in near if n[1]]}")
    print(f"[solve]   Lanczos sectors {len(stats)}: restarts "
          f"{sum(r for r, _, _ in stats)}, at the restart cap "
          f"{sum(r >= c for r, c, _ in stats)}, sweep matvecs "
          f"{sum(n for _, _, n in stats)}")
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
    return res, counts, wall


def _config2(precision: str):
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    cfg = default_config(norb=2, nbath=6, nspin=1, ed_verbose=3,
                         ed_precision=precision, **KANAMORI)
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    return cfg, bath


def phase_solve(report: dict) -> None:
    import torch
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.ops import kron_tiles as kt
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.ops.matvec import KronMatvec
    dev = torch.device(DEVICE)
    cfg, bath = _config2("float64")
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = _solve_once("config 2 f64 cold", cfg, bath)
    report["B1_launches"] = counts["B1"]
    report["cold"] = dict(wall_s=wall, matvecs=res.n_matvecs, **res.timings)
    if counts["B1"] <= 0:
        fail("config 2 f64 solve did not launch B1")
    print(f"[solve]   peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # ground-state sector re-solved through the dense-factor KronMatvec
    st = res.diag.state_list.states[0]
    sec = res.table.sector(st.sector)
    mv = KronMatvec(build_normal_sector_op(cfg, sec, res.hloc, res.um,
                                           res.bath), dev)
    vals, _ = eigsh_lowest(mv, mv.dim, 1, tol=1e-14)
    dev_e0 = abs(float(vals[0]) - res.e0)
    print(f"[solve] ground-state sector {sec.qn} dim {sec.dim}: KronMatvec "
          f"e0 {vals[0]:.12f}, solve e0 {res.e0:.12f}, |diff| {dev_e0:.3e}")
    if not dev_e0 <= 1e-10:
        fail(f"ground-state e0 disagrees with KronMatvec ({dev_e0:.3e})")
    # the (7,7) sector's lowest level through the row-gather Kron operator
    # (B4)
    sec77 = res.table.by_qn(("n", (7,), (7,)))
    e77 = float(res.diag.evals_by_sector[sec77.index][0])
    tiles = kt.KronTileMatvec(build_normal_sector_op(
        cfg, sec77, res.hloc, res.um, res.bath), dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats: dict = {}
    vals, _ = eigsh_lowest(tiles, tiles.dim, 1, dtype=torch.float32, m=48,
                           tol=1e-14, max_restarts=10, stats=stats)
    torch.cuda.synchronize()
    counts = read_counts()
    rel77 = abs(float(vals[0]) - e77) / abs(e77)
    print(f"[solve] (7,7) dim {sec77.dim} through B4 (f32 Lanczos): e "
          f"{vals[0]:.9f} vs f64 solve {e77:.9f}, rel {rel77:.3e} (limit "
          f"{E0_F32_RTOL}); {stats['n_matvecs']} matvecs, "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    report["B4_launches"] = counts["B4"]
    if counts["B4"] <= 0 or not rel77 <= E0_F32_RTOL:
        fail(f"B4 Lanczos: launches {counts['B4']}, rel {rel77:.3e}")
    e0_64 = res.e0
    kept64 = {qn: sorted([(e, None) for e, _ in st], key=lambda t: t[0])
              for qn, st in _kept(res).items()}
    obs64 = _observables()
    ed.ed_finalize_solver()
    # the first DMFT iteration of the dmft phase
    report["loop1"] = dict(cfg=cfg, res=res, wall=wall)
    del tiles, mv
    # config 2 in f32 through ed_solve (auto: B2 for dim >= 2^17)
    cfg32, bath32 = _config2("float32")
    res32, counts, wall = _solve_once("config 2 f32 cold", cfg32, bath32)
    report["B2_launches"] = counts["B2"]
    report["cold_f32"] = dict(wall_s=wall, matvecs=res32.n_matvecs,
                              **res32.timings)
    rel = abs(res32.e0 - e0_64) / abs(e0_64)
    print(f"[solve]   f32 e0 {res32.e0:.9f} vs f64 {e0_64:.12f}: rel "
          f"{rel:.3e} (limit {E0_F32_RTOL})")
    if counts["B2"] <= 0:
        fail("config 2 f32 solve did not launch B2")
    if not rel <= E0_F32_RTOL:
        fail(f"config 2 f32 e0 off by {rel:.3e} relative")
    _check_kept(_kept(res32), kept64, e0_64)
    obs32 = _observables()
    for k, ref in obs64.items():
        dev = float(np.abs(obs32[k] - ref).max())
        print(f"[solve]   f32 {k} vs f64: max dev {dev:.3e} (limit "
              f"{TOL_F32_EXACT[k]})")
        if not dev <= TOL_F32_EXACT[k]:
            fail(f"config 2 f32 {k} off the f64 solve's by {dev:.3e}")
    ed.ed_finalize_solver()


def _dmft_loops(cfg, nloops: int) -> list:
    """``nloops`` Bethe DMFT iterations of ``cfg`` (the current config) on
    the card through the ed_* API, as tests/gen_torch_golden.py runs them
    in edipack_tpu: solve, then fit the bath to Δ = (D/2)² G."""
    import edipack_tpu_torch.main as ed
    z = _z(cfg.beta)
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    out = []
    for _ in range(nloops):
        res = ed.ed_solve(bath)
        delta = (WBAND / 2.0) ** 2 * ed.ed_get_gimp(axis="m")
        t0 = time.perf_counter()
        bath = ed.ed_chi2_fitgf(delta, bath, ispin=1)
        out.append(dict(e0=res.e0, dens=ed.ed_get_dens(),
                        docc=ed.ed_get_docc(), gimp=ed.ed_get_gimp(z),
                        sigma=ed.ed_get_sigma(z), bath=np.asarray(bath),
                        fit_s=time.perf_counter() - t0))
    ed.ed_finalize_solver()
    return out


def _dmft_golden(report: dict) -> None:
    """Two DMFT iterations at norb=2, nbath=4 through B1 against the
    edipack_tpu golden file: loop 1 at TOL, the fitted baths and loop 2 at
    TOL_DMFT."""
    import edipack_tpu_torch as ed
    with open(GOLDEN_DMFT) as fh:
        gold = json.load(fh)
    cfg = ed.set_config(ed.default_config(**gold["config"], ed_verbose=0,
                                          ed_fused_matvec="always"))
    reset_counts()
    loops = _dmft_loops(cfg, len(gold["loops"]))
    launched = read_counts()["B1"]
    for k, (got, want) in enumerate(zip(loops, gold["loops"])):
        tol = dict(TOL if k == 0 else TOL_DMFT, bath=TOL_DMFT["bath"])
        print(f"[dmft] golden loop {k + 1}: e0 {got['e0']:.12f} (ref "
              f"{want['e0']:.12f}), fit {got['fit_s']:.2f} s")
        for key in ("e0", "dens", "docc", "gimp", "sigma", "bath"):
            ref = _cplx(want[key]) if key in ("gimp", "sigma") else want[key]
            _check_close(f"{key} loop {k + 1}", got[key], ref, tol[key])
    print(f"[dmft] golden B1 launches {launched}")
    if launched <= 0:
        fail("the DMFT golden loops did not launch B1")


def _lanczos_nev(res, neigen) -> dict:
    """Lanczos sectors whose number of levels is not what ``neigen``
    asks for (diag._lanczos_solve_sector: min(neigen, dim - 1))."""
    bad = {}
    for i, ev in res.diag.evals_by_sector.items():
        dim = res.table.get_dim(i)
        if dim > res.cfg.lanc_dim_threshold \
                and len(ev) != min(max(int(neigen[i]), 1), dim - 1):
            bad[i] = (len(ev), int(neigen[i]))
    return bad


def phase_dmft(report: dict) -> None:
    """(a) the n2b4 DMFT golden; (b) config 2's second DMFT iteration from
    the restart files its first (phase_solve's f64 solve) writes."""
    import tempfile
    import torch
    import edipack_tpu_torch as ed
    from edipack_tpu_torch import io as edio
    from edipack_tpu_torch.bath.dmft_bath import bath_to_array
    from edipack_tpu_torch.bath.fit import chi2_function, value_and_grad
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.ops.matvec import KronMatvec
    _dmft_golden(report)
    loop1 = report.pop("loop1")
    res1 = loop1["res"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dmft_") as out:
        cfg = ed.set_config(loop1["cfg"].replace(
            ed_write_files=True, ed_output_dir=out,
            hfile=os.path.join(out, "hamiltonian")))
        # 1. fit the bath to Δ = (D/2)² G of the first iteration
        bath1 = bath_to_array(res1.bath)
        delta1 = (WBAND / 2.0) ** 2 * res1.get_gimp(axis="m")
        chi2, p_full, idx = chi2_function(cfg, delta1, bath1)
        fun = value_and_grad(chi2)
        idx = idx.numpy()
        t0 = time.perf_counter()
        bath2 = ed.ed_chi2_fitgf(delta1, bath1, ispin=1)
        fit_s = time.perf_counter() - t0
        chi_before, chi_after = fun(bath1[idx])[0], fun(bath2[idx])[0]
        t0 = time.perf_counter()
        for _ in range(20):
            fun(bath2[idx])
        eval_ms = (time.perf_counter() - t0) / 20 * 1e3
        print(f"[dmft] config 2 fit (host CPU, {len(idx)} parameters, lfit "
              f"{cfg.lfit}, cg_method {cfg.cg_method}): {fit_s:.2f} s "
              f"({fit_s / loop1['wall']:.3f} of loop 1's solve), chi2 "
              f"{chi_before:.6e} -> {chi_after:.6e}; chi2 and gradient "
              f"{eval_ms:.3f} ms an evaluation, so about "
              f"{fit_s / eval_ms * 1e3:.0f} evaluations")
        if not (np.all(np.isfinite(bath2)) and chi_after < chi_before):
            fail(f"config 2 fit: chi2 {chi_before:.3e} -> {chi_after:.3e}")
        # 2. the restart files: the first iteration's outputs, the bath
        edio.write_all_outputs(cfg, res1)
        ed.ed_save_array_as_bath(bath2, cfg=cfg)
        # 3. a new solver from hamiltonian.restart
        adopted = ed.ed_init_solver(cfg=cfg, device=DEVICE)
        if not np.array_equal(adopted, bath2):
            fail("ed_init_solver did not adopt hamiltonian.restart bit for "
                 f"bit (max dev {np.abs(adopted - bath2).max():.3e})")
        ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
        neigen = edio.read_state_list_restart(cfg, res1.table)
        # 4. the second iteration through ed_solve
        res2, counts, wall = _solve_once("config 2 DMFT loop 2 f64", cfg,
                                         None)
        print(f"[dmft]   neigen_sector from state_list.restart: "
              f"{sorted(set(neigen.tolist()))} (loop 1: "
              f"{cfg.lanc_nstates_sector}); loop 1 wall {loop1['wall']:.2f} "
              f"s, {res1.n_matvecs} matvecs")
        bad = _lanczos_nev(res2, neigen)
        if bad:
            fail(f"loop 2 did not take neigen from state_list.restart: {bad}")
        if counts["B1"] <= 0:
            fail("config 2 DMFT loop 2 did not launch B1")
        obs = np.loadtxt(os.path.join(out, "observables_last.ed"))
        dev_d = float(np.abs(obs[:cfg.norb] - ed.ed_get_dens()).max())
        print(f"[dmft]   observables_last.ed dens vs ed_get_dens: {dev_d:.3e}"
              f" (limit 1e-10)")
        if not dev_d <= 1e-10:
            fail(f"observables_last.ed off ed_get_dens by {dev_d:.3e}")
        st = res2.diag.state_list.states[0]
        sec = res2.table.sector(st.sector)
        mv = KronMatvec(build_normal_sector_op(cfg, sec, res2.hloc, res2.um,
                                               res2.bath),
                        torch.device(DEVICE))
        vals, _ = eigsh_lowest(mv, mv.dim, 1, tol=1e-14)
        dev_e0 = abs(float(vals[0]) - res2.e0)
        print(f"[dmft]   ground-state sector {sec.qn} dim {sec.dim}: "
              f"KronMatvec e0 {vals[0]:.12f}, solve e0 {res2.e0:.12f}, "
              f"|diff| {dev_e0:.3e}")
        if not dev_e0 <= 1e-10:
            fail(f"loop 2 e0 disagrees with KronMatvec ({dev_e0:.3e})")
        delta2 = (WBAND / 2.0) ** 2 * ed.ed_get_gimp(axis="m")
        err = float(np.sum(np.abs(delta2 - delta1)) / np.sum(np.abs(delta2)))
        rel = float(np.abs(delta2 - delta1).max() / np.abs(delta1).max())
        print(f"[dmft]   Δ loop 1 -> 2: sum|ΔΔ|/sum|Δ| {err:.4e}, max "
              f"{rel:.4e} relative")
        ed.ed_finalize_solver()
    report["B1_launches_dmft"] = counts["B1"]


# ---------------------------------------------------------------------------
# phase extras: susceptibilities, impurity RDM, Krylov complexity, finite T,
# per-orbital sectors and runtime two-body terms
# ---------------------------------------------------------------------------


def _extras_start(gold: dict, config: dict, terms=()):
    """A solver of ``config`` (made the current config) on the card through
    B1, with the golden file's Hloc and the runtime two-body ``terms``."""
    import edipack_tpu_torch as ed
    cfg = ed.set_config(ed.default_config(**config, ed_verbose=0,
                                          ed_fused_matvec="always"))
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.asarray(gold["hloc"]).reshape(1, 1, 2, 2))
    for t in terms:
        ed.ed_add_twobody_operator(*t)
    return cfg, bath


def _extras_solve(label: str, bath, launches: list):
    """ed_solve with the counters reset just before; its B1 launches are
    appended to ``launches`` and must be above 0."""
    import torch
    import edipack_tpu_torch as ed
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    torch.cuda.synchronize()
    n = read_counts()["B1"]
    launches.append(n)
    print(f"[extras] {label}: e0 {res.e0:.12f}, {time.perf_counter() - t0:.2f}"
          f" s, {res.n_matvecs} matvecs, B1 launches {n}")
    if n <= 0:
        fail(f"extras golden {label}: no B1 launch")
    return res


def _bosonic(beta: float) -> np.ndarray:
    """ν_1 .. ν_NMATS (ν_0 left out, as the golden file does)."""
    return 1j * 2 * np.pi / beta * np.arange(1, NMATS + 1)


def _check_rel(what: str, got, want, tol: float) -> None:
    """``got`` against ``want`` relative to the largest |want|."""
    scale = float(np.abs(np.asarray(want)).max())
    if not scale > 0:
        fail(f"golden {what}: the reference is zero")
    _check_close(what + " (rel)", np.asarray(got) / scale,
                 np.asarray(want) / scale, tol)


def _extras_t0(gold: dict, launches: list) -> None:
    """The T=0 solve with the four χ flags and rdm_flag, then the Krylov
    state complexity."""
    import edipack_tpu_torch as ed
    t0 = gold["t0"]
    cfg, bath = _extras_start(gold, dict(gold["config"], **t0["config"]))
    if not np.array_equal(bath, np.asarray(t0["bath"])):
        fail("extras golden: the default bath differs from the file's")
    res = _extras_solve("T=0 with chi and rdm", bath, launches)
    print(f"[extras]   phases " + ", ".join(
        f"{k} {v:.2f} s" for k, v in res.timings.items()))
    reset_counts()
    kr = ed.ed_build_krylov_state_complexity()
    n = read_counts()["B1"]
    print(f"[extras]   Krylov state complexity: B1 launches {n}")
    if n <= 0:
        fail("extras golden: the Krylov chains launched no B1")
    launches.append(n)
    tol = TOL_EXTRAS
    _check_close("t0 e0", res.e0, t0["e0"], tol["e0"])
    _check_close("t0 dens", res.dens, t0["dens"], tol["dens"])
    _check_close("t0 docc", res.docc, t0["docc"], tol["docc"])
    _check_close("t0 energies", [ed.ed_get_epot(), ed.ed_get_eint(),
                                 ed.ed_get_ehartree(), ed.ed_get_eknot()],
                 t0["energies"], tol["energies"])
    _check_close("t0 sp_dm", np.real(ed.ed_get_sp_dm()), t0["sp_dm"],
                 tol["sp_dm"])
    # the golden file's χ grid: see tests/gen_torch_golden.py CHI_BETA_GRID
    z = _bosonic(gold["chi_beta_grid"])
    for kind, want in t0["chi"].items():
        _check_rel(f"t0 chi {kind}", ed.ed_get_chi(kind, z), _cplx(want),
                   tol["chi"])
    _check_close("t0 rdm", ed.ed_get_rdm(), t0["rdm"], tol["rdm"])
    _check_close("t0 reduced rdm", ed.ed_get_reduced_rdm(t0["reduced_mask"]),
                 t0["reduced_rdm"], tol["rdm"])
    for field, want in t0["krylov"].items():
        got = getattr(kr, field)
        for key, ref in want.items():
            op, s, o = key.split(",")
            _check_close(f"t0 {field[:7]} {key}", got[(op, int(s), int(o))],
                         ref, tol["krylov"])
    ed.ed_finalize_solver()


def _extras_finite_t(gold: dict, launches: list) -> None:
    """The finite-T sequence of one solver: budgets and neigen_sector
    exact, zeta, e0, dens and G, and histogram_states.ed as text."""
    import tempfile
    import edipack_tpu_torch as ed
    ft = gold["finite_t"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extras_") as out:
        cfg, bath = _extras_start(gold, dict(
            gold["config"], **ft["config"], ed_write_files=True,
            ed_output_dir=out))
        z = _z(cfg.beta)
        for k, want in enumerate(ft["solves"]):
            res = _extras_solve(f"finite T solve {k + 1}", bath, launches)
            budget = res.cfg.lanc_nstates_total      # the budget it took
            got_total = int(res.diag.lanc_nstates_total)
            print(f"[extras]   budget {budget} (file {want['budget_in']}), "
                  f"kept {len(res.diag.state_list)}, next budget "
                  f"{got_total} (file {want['lanc_nstates_total']})")
            if budget != want["budget_in"] \
                    or got_total != want["lanc_nstates_total"]:
                fail(f"finite T solve {k + 1}: budgets differ")
            if not np.array_equal(res.diag.neigen_sector,
                                  want["neigen_sector"]):
                fail(f"finite T solve {k + 1}: neigen_sector differs")
            _check_close(f"ft{k + 1} zeta (rel)", res.diag.zeta / want["zeta"],
                         1.0, TOL_EXTRAS["zeta"])
            _check_close(f"ft{k + 1} e0", res.e0, want["e0"], TOL["e0"])
            _check_close(f"ft{k + 1} dens", res.dens, want["dens"],
                         TOL["dens"])
            _check_close(f"ft{k + 1} gimp", ed.ed_get_gimp(z),
                         _cplx(want["gimp"]), TOL["gimp"])
        with open(os.path.join(out, "histogram_states.ed")) as fh:
            hist = fh.read()
    print(f"[extras]   histogram_states.ed: {len(hist.splitlines())} lines, "
          f"{'as' if hist == ft['histogram'] else 'NOT as'} the file's")
    if hist != ft["histogram"]:
        fail("histogram_states.ed differs from the golden text")
    ed.ed_finalize_solver()


def _extras_simple(gold: dict, part: str, config: dict, terms,
                   launches: list) -> None:
    import edipack_tpu_torch as ed
    want = gold[part]
    cfg, bath = _extras_start(gold, config, terms)
    res = _extras_solve(part, bath, launches)
    _check_close(f"{part} e0", res.e0, want["e0"], TOL["e0"])
    _check_close(f"{part} dens", res.dens, want["dens"], TOL["dens"])
    if part == "total_ud":
        _check_close(f"{part} docc", res.docc, want["docc"], TOL["docc"])
        _check_close(f"{part} gimp",
                     ed.ed_get_gimp(_z(cfg.beta)),
                     _cplx(want["gimp"]), TOL["gimp"])
    ed.ed_finalize_solver()


def _extras_golden(report: dict) -> None:
    """(a) the n2b4 extras golden through B1."""
    with open(GOLDEN_EXTRAS) as fh:
        gold = json.load(fh)
    launches: list = []
    _extras_t0(gold, launches)
    _extras_finite_t(gold, launches)
    _extras_simple(gold, "total_ud", dict(gold["config"],
                                          **gold["total_ud"]["config"]),
                   (), launches)
    _extras_simple(gold, "twobody", gold["config"],
                   [tuple(t) for t in gold["twobody"]["terms"]], launches)
    print(f"[extras] golden B1 launches per solve (the T=0 solve, its Krylov "
          f"chains, the finite-T solves, ed_total_ud=False, the two-body "
          f"term): {launches}")
    report["B1_launches_extras_golden"] = int(sum(launches))


def _chi_norms(res) -> dict:
    """Σ_i w_i ‖O ψ_i‖² for every χ channel that build_chi_normal adds
    with a + sign: the operators applied to the kept states on the card,
    with no Lanczos chain and no B1."""
    import torch
    from edipack_tpu_torch.fock import occupations
    from edipack_tpu_torch.ops.sector_ops import spin_axis_op
    from edipack_tpu_torch.solver.chi import _diag_op_apply, _hop_axis_apply
    cfg, table = res.cfg, res.table
    norb, ns = cfg.norb, table.dims.ns
    w = res.diag.state_list.boltzmann_weights()
    out: dict = {}

    def add(key, phi, wi):
        out[key] = out.get(key, 0.0) + wi * float(torch.sum(phi * phi))

    for wi, st in zip(w, res.diag.state_list):
        sec = table.sector(st.sector)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        occ_u = occupations(sec.ups, ns).astype(float)[:, :norb]
        occ_d = occupations(sec.dws, ns).astype(float)[:, :norb]
        for a in range(norb):
            add(("spin", a, a), _diag_op_apply(v3, 0.5 * occ_u[:, a],
                                               -0.5 * occ_d[:, a]), wi)
            add(("dens", a, a), _diag_op_apply(v3, occ_u[:, a],
                                               occ_d[:, a]), wi)
            for kind, ups in (("c", table.c_sector), ("cdg",
                                                      table.cdg_sector)):
                mid = ups(st.sector, 0)
                tgt = ups(mid, 1) if mid is not None else None
                if tgt is None:
                    continue
                m, t = table.sector(mid), table.sector(tgt)
                phi = spin_axis_op(m.dws, t.dws, ns, kind, a, 1).apply(
                    spin_axis_op(sec.ups, m.ups, ns, kind, a, 2).apply(v3))
                add(("pair", a, a), phi, wi)
        for a in range(norb):
            for b in range(a + 1, norb):
                for key, s_dw in (("exct_s", 1.0), ("exct_tz", -1.0)):
                    for i, j in ((a, b), (b, a)):
                        add((key, a, b),
                            _hop_axis_apply(v3, sec.ups, ns, i, j, 2)
                            + s_dw * _hop_axis_apply(v3, sec.dws, ns, i, j,
                                                     1), wi)
                for s_c, s_d, ax_c, ax_d in ((0, 1, 2, 1), (1, 0, 1, 2)):
                    mid = table.c_sector(st.sector, s_c)
                    tgt = table.cdg_sector(mid, s_d) \
                        if mid is not None else None
                    if tgt is None:
                        continue
                    m, t = table.sector(mid), table.sector(tgt)
                    src_b = sec.ups if s_c == 0 else sec.dws
                    mid_b = m.ups if s_c == 0 else m.dws
                    mid_d = m.dws if s_c == 0 else m.ups
                    tgt_d = t.dws if s_c == 0 else t.ups
                    phi = spin_axis_op(mid_d, tgt_d, ns, "cdg", a,
                                       ax_d).apply(spin_axis_op(
                                           src_b, mid_b, ns, "c", b,
                                           ax_c).apply(v3))
                    add(("exct_t", a, b), phi, wi)
    return out


def _plus_weights(chi, key) -> float:
    """The weights of ``key`` that build_chi_normal adds with a + sign: the
    first half of each add of a Hermitian channel (spin, dens: + and -
    poles), all of them for pair and the exciton channels."""
    herm = key[0] in ("spin", "dens")
    return float(sum(np.real(wt[:len(wt) // 2] if herm else wt).sum()
                     for wt, _ in chi.channels[key]))


def _first_moment(res, key) -> tuple:
    """Σ weight × pole of χ channel ``key`` (the + half of a Hermitian
    channel), against Σ_i w_i (<φ_i|H|φ_i> - E_i <φ_i|φ_i>) with each φ_i
    taken through KronMatvec of its target sector (not B1): for spin
    (a, a) the Sz_a excitation in the state's own sector; for pair (a, a),
    whose store holds the lesser c_a↓c_a↑ (poles E_n - E_i) and the greater
    c†c† (poles E_i - E_n) together, the lesser moment minus the greater
    one. Returns (store, KronMatvec, scale): the scale is the sum of the
    magnitudes of the terms, since the two pair moments nearly cancel
    where the model is particle-hole symmetric."""
    import torch
    from edipack_tpu_torch.fock import occupations
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.ops.matvec import KronMatvec
    from edipack_tpu_torch.ops.sector_ops import spin_axis_op
    from edipack_tpu_torch.solver.chi import _diag_op_apply
    cfg, table = res.cfg, res.table
    ns, a = table.dims.ns, key[1]
    dev = torch.device(DEVICE)
    w = res.diag.state_list.boltzmann_weights()
    kron: dict = {}

    def moment(isec, phi):
        if isec not in kron:
            kron[isec] = KronMatvec(build_normal_sector_op(
                cfg, table.sector(isec), res.hloc, res.um, res.bath), dev)
        f = phi.reshape(-1)
        return float(f @ kron[isec](f)), float(f @ f)

    want = scale = 0.0
    for wi, st in zip(w, res.diag.state_list):
        sec = table.sector(st.sector)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        if key[0] == "spin":
            occ_u = occupations(sec.ups, ns).astype(float)[:, a]
            occ_d = occupations(sec.dws, ns).astype(float)[:, a]
            hphi, nphi = moment(st.sector, _diag_op_apply(
                v3, 0.5 * occ_u, -0.5 * occ_d))
            want += wi * (hphi - st.energy * nphi)
            scale += abs(wi * (hphi - st.energy * nphi))
            continue
        for kind, step, sign in (("c", table.c_sector, 1.0),
                                 ("cdg", table.cdg_sector, -1.0)):
            mid = step(st.sector, 0)
            tgt = step(mid, 1) if mid is not None else None
            if tgt is None:
                continue
            m, t = table.sector(mid), table.sector(tgt)
            phi = spin_axis_op(m.dws, t.dws, ns, kind, a, 1).apply(
                spin_axis_op(sec.ups, m.ups, ns, kind, a, 2).apply(v3))
            hphi, nphi = moment(tgt, phi)
            want += sign * wi * (hphi - st.energy * nphi)
            scale += abs(wi * (hphi - st.energy * nphi))
    herm = key[0] == "spin"
    got = 0.0
    for wt, p in res.chi.channels[key]:
        half = len(wt) // 2 if herm else len(wt)
        got += float(np.real(wt[:half]) @ p[:half])
    return got, want, scale


def _rdm_checks(res) -> None:
    """Trace 1, Hermitian, eigenvalues >= -RDM_TOL; its diagonal gives the
    solve's dens and docc."""
    rho = np.asarray(res.rdm)
    norb = res.cfg.norb
    nimp = 1 << norb
    idx = np.arange(nimp * nimp)
    iu, idw = idx % nimp, idx // nimp
    diag = np.diag(rho)
    ev = np.linalg.eigvalsh(0.5 * (rho + rho.T))
    dens = np.array([diag @ (((iu >> a) & 1) + ((idw >> a) & 1))
                     for a in range(norb)])
    docc = np.array([diag @ (((iu >> a) & 1) * ((idw >> a) & 1))
                     for a in range(norb)])
    tr, herm = abs(np.trace(rho) - 1.0), float(np.abs(rho - rho.T).max())
    dd = float(np.abs(dens - res.dens).max())
    dc = float(np.abs(docc - res.docc).max())
    print(f"[extras]   RDM {rho.shape}: |trace - 1| {tr:.3e}, Hermiticity "
          f"{herm:.3e}, lowest eigenvalue {ev[0]:.3e} (limit {RDM_TOL}); "
          f"diagonal vs dens {dd:.3e}, vs docc {dc:.3e} (limit "
          f"{IDENTITY_RTOL})")
    if not (tr <= RDM_TOL and herm <= RDM_TOL and ev[0] >= -RDM_TOL
            and dd <= IDENTITY_RTOL and dc <= IDENTITY_RTOL):
        fail("config 2 RDM identities")


def _extras_config2(report: dict) -> None:
    """(b) config 2 at full width with the χ flags and rdm_flag, then the
    Krylov state complexity; held by identities that B1 does not enter."""
    import torch
    import edipack_tpu_torch as ed
    from edipack_tpu_torch.solver import core
    cfg = ed.default_config(norb=2, nbath=6, nspin=1, ed_verbose=0,
                            **KANAMORI, **CHI_FLAGS)
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    # B1 launches of the χ phase: read around build_chi_normal
    chi_counts: dict = {}
    build_chi = core.build_chi_normal

    def counted(*args, **kw):
        before = read_counts()["B1"]
        try:
            return build_chi(*args, **kw)
        finally:
            chi_counts["B1"] = read_counts()["B1"] - before

    core.build_chi_normal = counted
    torch.cuda.reset_peak_memory_stats()
    try:
        res, counts, wall = _solve_once("config 2 f64 cold, chi and rdm",
                                        cfg, bath)
    finally:
        core.build_chi_normal = build_chi
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[extras]   B1 launches: solve {counts['B1']} (of them the chi "
          f"phase {chi_counts['B1']}); peak device memory {peak:.2f} GiB")
    if chi_counts["B1"] <= 0:
        fail("config 2 chi phase launched no B1")
    # sum rules
    norms = _chi_norms(res)
    dens, docc = res.dens, res.docc
    worst = 0.0
    for key, ref in sorted(norms.items()):
        got = _plus_weights(res.chi, key)
        rel = abs(got - ref) / max(abs(ref), 1e-300)
        worst = max(worst, rel)
        extra = ""
        if key[0] == "spin":
            f = (dens[key[1]] - 2 * docc[key[1]]) / 4
            extra = f", (n - 2d)/4 {f:.12f}"
            worst = max(worst, abs(got - f) / abs(f))
        if key[0] == "dens":
            f = dens[key[1]] + 2 * docc[key[1]]
            extra = f", n + 2d {f:.12f}"
            worst = max(worst, abs(got - f) / abs(f))
        print(f"[extras]   sum rule {key}: + weights {got:.12f}, "
              f"Σ w‖Oψ‖² {ref:.12f}{extra}")
    print(f"[extras]   sum rules: worst rel {worst:.3e} (limit "
          f"{IDENTITY_RTOL})")
    if not worst <= IDENTITY_RTOL:
        fail(f"config 2 chi sum rules off by {worst:.3e}")
    for key in (("spin", 0, 0), ("pair", 0, 0)):
        got, want, scale = _first_moment(res, key)
        rel = abs(got - want) / scale
        print(f"[extras]   first moment {key}: Σ weight × pole {got:.12e}, "
              f"KronMatvec {want:.12e}, rel to {scale:.6e}: {rel:.3e} "
              f"(limit {IDENTITY_RTOL})")
        if not rel <= IDENTITY_RTOL:
            fail(f"config 2 chi first moment {key} off by {rel:.3e}")
    _rdm_checks(res)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kr = ed.ed_build_krylov_state_complexity()
    torch.cuda.synchronize()
    kry_s = time.perf_counter() - t0
    kry = read_counts()["B1"]
    worst_p = max(float(np.abs(p.sum(0) - 1.0).max())
                  for p in kr.distribution.values())
    k0 = max(abs(float(k[0])) for k in kr.complexity.values())
    print(f"[extras]   Krylov state complexity: {kry_s:.2f} s, B1 launches "
          f"{kry}, keys {sorted(kr.complexity)}; distribution sums to 1 "
          f"within {worst_p:.3e} (limit {RDM_TOL}), |K(0)| {k0:.3e}; K(tmax) "
          + ", ".join(f"{k}: {v[-1]:.6f}" for k, v in
                      sorted(kr.complexity.items())))
    if not (worst_p <= RDM_TOL and k0 <= RDM_TOL and kry > 0):
        fail("config 2 Krylov state complexity")
    report["B1_launches_extras"] = counts["B1"] + kry
    report["extras"] = dict(wall_s=wall, matvecs=res.n_matvecs,
                            krylov_s=kry_s, peak_gib=peak, **res.timings)
    ed.ed_finalize_solver()


def phase_extras(report: dict) -> None:
    _extras_golden(report)
    _extras_config2(report)


def _observables() -> dict:
    import edipack_tpu_torch.main as ed
    return dict(dens=ed.ed_get_dens(), docc=ed.ed_get_docc(),
                energies=ed.ed_get_eimp(), gimp=ed.ed_get_gimp(_z(BETA_GRID)))


def _kept(res) -> dict:
    """The kept states by sector: {qn: [(energy, vector), ...]}."""
    out: dict = {}
    for st in res.diag.state_list.states:
        out.setdefault(res.table.sector(st.sector).qn, []).append(
            (st.energy, st.vector))
    return out


def _check_kept(kept32: dict, kept64: dict, e0_64: float) -> None:
    """The f32 solve's kept states against the f64 solve's: as many in
    each sector, the states of one sector overlapping by at most
    KEPT_OVERLAP, and each energy within E0_F32_RTOL of the f64 energy of
    the same rank in its sector."""
    worst_e, worst_o = 0.0, 0.0
    for qn in set(kept32) | set(kept64):
        states, ref = kept32.get(qn, []), kept64.get(qn, [])
        if len(states) != len(ref):
            fail(f"config 2 f32 keeps {len(states)} states in {qn}, the f64 "
                 f"solve {len(ref)}")
        for (e, _), (e64, _) in zip(sorted(states, key=lambda t: t[0]), ref):
            worst_e = max(worst_e, abs(e - e64) / abs(e0_64))
        vecs = [v.double() for _, v in states]
        for i in range(len(vecs)):
            for j in range(i):
                worst_o = max(worst_o, abs(float(vecs[i] @ vecs[j])))
    print(f"[solve]   f32 kept states vs f64: sectors "
          f"{sorted(q[1:] for q in kept32)} of {sorted(q[1:] for q in kept64)}"
          f", energies rel {worst_e:.3e} (limit {E0_F32_RTOL}), overlap "
          f"within a sector {worst_o:.3e} (limit {KEPT_OVERLAP})")
    if not (worst_e <= E0_F32_RTOL and worst_o <= KEPT_OVERLAP):
        fail(f"config 2 f32 kept states: energies {worst_e:.3e}, overlap "
             f"{worst_o:.3e}")


def _library(pairs) -> dict:
    """The fastest of the yardsticks ((name, ms) pairs) and its name."""
    name, ms = min(pairs, key=lambda p: p[1])
    return dict(library_ms=ms, library_call=name)


def kernel_report(report: dict) -> list:
    big = report["fused"][0]                 # config 2's (7,7) sector
    kron = report["kron"][0]
    pw = report["power"]
    src = "edipack_tpu_torch/csrc/"
    csr = ("D*V + torch.sparse.mm(Hdw_csr, V) + torch.sparse.mm(Hup_csr, "
           "V.T).T, {} (cuSPARSE; Jx/Jp terms left out)")
    return [
        dict(name="fused_normal_matvec_f64", route="cuda",
             source=src + "row_gather.cu",
             replaces="edipack_tpu/ops/pallas_fused.py:237",
             launches=report["B1_launches"],
             launches_dmft_loop2=report["B1_launches_dmft"],
             launches_extras_golden=report["B1_launches_extras_golden"],
             launches_extras_config2=report["B1_launches_extras"],
             max_abs_err=max(s["err64"] for s in report["fused"]),
             ms=big["b1"], ms_back_to_back=big["b1_b2b"],
             plain_ms=big["b1_plain"],
             bound_ms=big["bound64"]["bound_ms"],
             bound_by=big["bound64"]["bound_by"],
             **_library([(csr.format("f64"), big["b1_csr"])])),
        dict(name="fused_normal_matvec_f32", route="cuda",
             source=src + "row_gather.cu",
             replaces="edipack_tpu/ops/pallas_fused.py:134",
             launches=report["B2_launches"],
             max_abs_err=max(s["err32"] for s in report["fused"]),
             ms=big["b2"], ms_back_to_back=big["b2_b2b"],
             plain_ms=big["b2_plain"],
             bound_ms=big["bound32"]["bound_ms"],
             bound_by=big["bound32"]["bound_by"],
             **_library([(csr.format("f32"), big["b2_csr"])])),
        dict(name="fused_normal_power_f32", route="cuda",
             source=src + "row_gather.cu",
             replaces="edipack_tpu/ops/pallas_fused.py:248",
             launches=pw["launches"], max_abs_err=pw["err"],
             ms=pw["ms"], ms_back_to_back=pw["ms_b2b"],
             plain_ms=pw["plain_ms"],
             bound_ms=pw["bound"]["bound_ms"],
             bound_by=pw["bound"]["bound_by"],
             **_library([(csr.format("f32") + " with vector_norm and scale",
                          pw["csr"])]),
             per="power step"),
        dict(name="kron_tiles_matvec_f32", route="cuda",
             source=src + "row_gather.cu",
             replaces="edipack_tpu/ops/pallas_kron.py:22",
             launches=report["B4_launches"],
             max_abs_err=max(s["err"] for s in report["kron"]),
             ms=kron["b4"], ms_back_to_back=kron["b4_b2b"],
             plain_ms=kron["b4_plain"],
             bound_ms=kron["bound"]["bound_ms"],
             bound_by=kron["bound"]["bound_by"],
             **_library([(csr.format("f32"), kron["csr"]),
                         ("V @ Hup.T + Hdw @ V, f32 dense (cuBLAS)",
                          kron["gemm"])])),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import edipack_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())          # name, power limit, as nvidia-smi gives them
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report: dict = {}
    t_all = time.perf_counter()
    for name, fn in (("build", phase_build), ("kernel", phase_kernel),
                     ("golden", phase_golden), ("solve", phase_solve),
                     ("dmft", phase_dmft), ("extras", phase_extras)):
        t0 = time.perf_counter()
        fn(report)
        print(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[done] all phases in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernel_report(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
