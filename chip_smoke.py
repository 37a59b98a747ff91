#!/usr/bin/env python3
"""Smoke run of edipack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, run in this order (each raises on failure; the exit code is
non-zero on any fault). Once the solve phase is done, the LANE phases
(mesh, joint, then dmft) run in a second process of this script
(``--lane OUT E77``, in a process group of its own, killed with the
script) beside the main phases (trace, extras, ineq, capi), whose
host-bound solves leave the card idle most of the time; its log is
printed and its report read once the main phases are done, and its
failure fails the run. Every kernel time of the kernel report is taken
before it starts:
  build   build the CUDA kernels from csrc/ (one nvcc per source, started
          together) and print nvcc's register report of each kernel; (f)
          the native host library (edipack_tpu_torch/native, g++): whether
          it runs, its enumeration of config 3's registers against
          NumPy's (EDIPACK_TPU_TORCH_NO_NATIVE=1), and the enumeration's
          share of config 3's largest joint host build
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
  trace   config 1 (norb=1, nbath=4) solved twice, the second time with
          ed_profile_dir under build/: one torch.profiler Chrome trace
          written, holding CUDA kernel events, and the traced solve's e0,
          G, dens and docc equal to the untraced one's (TRACE_TOL)
  dmft    the DMFT loop on the card: (a) two Bethe-lattice iterations
          (solve, Δ = (D/2)² G, ed_chi2_fitgf) at norb=2, nbath=4 through
          B1, held to tests/data/torch_port_golden_dmft_n2b4.json; (b) the
          second iteration of config 2 cut to DMFT_NBATH = 4 bath levels,
          every Lanczos sector through B1:
          a cold f64 solve (its first iteration), the bath fitted to its Δ,
          the restart files written, a new solver started from
          hamiltonian.restart and state_list.restart, and its ed_solve
          through B1 with ed_write_files on, checked like the first
  extras  the normal-mode extras through B1, in f64: the n2b4 extras
          golden (tests/data/torch_port_golden_extras_n2b4.json, from
          edipack_tpu): a T=0 solve with the four χ flags and rdm_flag (χ
          on ν_1..ν_32 of β = 20, RDM, a reduced RDM, energies, sp_dm) and
          its Krylov
          state complexity; three finite-T solves of one solver (budgets
          and neigen_sector exact, zeta, e0, dens, G, histogram_states.ed
          as text); an ed_total_ud=False solve; a runtime two-body term;
          each with B1 launches > 0. The config 2 extras checks run on the
          ineq phase's sweep
  ineq    inequivalent sites (EDIneqSolver) through B1: (a) the ineq golden
          (tests/data/torch_port_golden_ineq.json, from edipack_tpu): three
          n2b4 sites with a staggered Hloc and per-site uloc_ii / ust_ii, a
          full call (the statics-only call is left to the CPU test
          tests/test_torch_ineq.py), fit_gf by L-BFGS-B to (D/2)² G
          and the second iteration from the fitted baths, every site held
          at the solve goldens' TOL (the fit and the second iteration at
          the DMFT golden's), then two superc sites through the per-site
          loop; (b) EDIneqSolver(2) at config 2's width with the χ flags
          and rdm_flag, one site-batched sweep: site 1 is config 2 and
          equals the solve phase's f64 solve (e0 1e-10; dens, docc, G
          1e-8), site 2 (Hloc -0.1, Uloc 2.5) has its ground-state sector
          re-solved through KronMatvec (e0 1e-10), the GF weights of
          every diagonal channel of both sum to 1 (1e-10); on both sites,
          identities B1 does not enter: each χ channel's + weights sum to
          Σ_i w_i ‖Oψ_i‖² (and, for spin and dens, to (n - 2d)/4 and n + 2d
          of the solve's dens and docc), the first moments of the spin and
          pair channels of orbital 0 against KronMatvec, the RDM's trace,
          Hermiticity, eigenvalues and diagonal; then site 1's Krylov state
          complexity (normalization, K(0) = 0)
  capi    the C library: libedipack_tpu_torch_c.so built by
          edipack_tpu_torch/capi/build.py (gcc, this interpreter's
          sysconfig), the edtpu_* and the reference-ABI lattice drivers of
          capi/drivers/ built and run, each in a process of its own with
          EDIPACK_TPU_TORCH_DEVICE=cuda and ED_FUSED_MATVEC=always, at the
          ineq golden's two-site case: their printed dens, docc, energies
          and G held to the golden at TOL, no traceback on stderr, B1
          launches (from EDIPACK_TPU_TORCH_LAUNCH_LOG) > 0; then a bad
          EDIPACK_TPU_TORCH_DEVICE must make edtpu_init fail with the
          allowlist's message; beside them the C example
          (examples/c/hm_bethe.c, built by examples/c/build.py) runs two
          DMFT loops on the card: its printed numbers finite, and loop 1's
          density equal to the Python path's (ed_solve of the same
          problem in this process) at its printed precision
  mesh    multi-GPU on torch.distributed: MESH_WORLD ranks, each a
          process of this script (``--mesh-rank R DIR BACKEND``), over
          gloo with host-staged collectives on one card (NCCL, a card a
          rank, when there are as many cards): (a) B1 and B2 on each
          rank's row range of config 2's (7,7) sector, from the gathered
          V3, bitwise equal to the single-card kernels' rows, the
          sharded matvec (gather + kernel) timed beside the row-range
          kernel and the single-card one; (b) the (7,7) sector's lowest
          level by eigsh_lowest through the sharded B1 operator
          (MESH_RESTARTS sweeps) within 1e-10 of the single-card
          eigsh_lowest with the same sweeps; (c) config 2 at MESH_NBATH
          (largest sector 853,776 states, through B1 row ranges; one
          level a sector, twin sectors rebuilt) through ed_solve on the
          ranks against the unsharded solve of this process: e0 1e-10,
          dens, docc, G 1e-8, B1 launches > 0 on each rank; (d) BASELINE
          config 3 (superc, largest sector Sz=0 184,756 states) through
          the blocked Kron split over the ranks (every block's dw rows,
          ShardedJointKronMatvec) against its single-card Kron solve in
          this process: e0 1e-10, dens, docc, φ, G, F 1e-8, gathers > 0
          on each rank. The ranks' results come back through a temporary
          directory under build/; a rank that fails or outlives
          MESH_TIMEOUT fails the phase. Then (e) the edtpu_site C driver
          as MESH_WORLD processes of one group (RANK, WORLD_SIZE,
          MASTER_ADDR, MASTER_PORT, as torchrun sets them) at the n2b4
          golden's configuration with lanc_dim_threshold
          MESH_CAPI_THRESHOLD, so that its largest sectors ((5,5):
          63,504 states) split through B1's row ranges: each rank's
          numbers held to the golden at TOL, rank 0 alone writing files,
          each rank's launch log with B1 launches and gathers
  joint   the superc / nonsu2 modes in complex128 (no kernel of the four
          is on this path: the JAX joint operators are plain jnp, the
          port's are PyTorch): (a) the joint golden
          (tests/data/torch_port_golden_joint.json, the six cases of
          tests/joint_cases.py) through the ELL, direct and blocked-Kron
          routes, each at the golden's tolerances; (b) BASELINE config 3
          (superc, nbath=4) cold through ELL and blocked-Kron and (c)
          config 4 (nonsu2, nbath=3, spin-mixing Hloc) through ELL and
          direct: the two routes' e0, G, F, φ, dens, docc against each
          other, every kept state's residual through the other route's
          operator, complete ground multiplets, and the normal GF's
          weights summing to 1 per channel; every GF chain into one target
          sector runs in one batched chain (the chains one at a time
          against batched: tests/test_torch_gf_batch.py); (d) the
          reference-scale superc Sz=0 sector at nbath=5 (2,704,156 states): the ELL, the
          blocked-Kron (one gather group a block pair, and in groups of
          <= 6 terms) and a cuSPARSE complex128 CSR product held to each
          other and timed as the kernels are, with their byte bounds, then
          its lowest level by eigsh_lowest on the ELL with its residual
          (the nonsu2 Ntot=12 sector, ``_big_sector(report, "nonsu2")``,
          is left out for time)

Each kernel's path (the f64 solve for B1, the f32 solve for B2, the
power-step entry for B3, the row-gather Lanczos for B4, and for B1 also
the second DMFT iteration, the extras golden's solves and Krylov
chains, the ineq golden's sweeps, config 2's two-site sweep and its
Krylov chains, each C driver, whose process writes its counts at
finalize, each mesh rank's sharded solve, counted in the rank's
process, and each rank of the C driver on a group) runs with every
launch counter set to 0 just before it and read just after. The line
before the last is the kernel report (JSON), printed only once every phase has
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
GOLDEN_INEQ = os.path.join(DATA, "torch_port_golden_ineq.json")
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
# the dmft phase's second iteration runs config 2 with 4 bath levels, every
# Lanczos sector through B1 (ed_fused_matvec "always"): at nbath 6 it took
# 133.4 s plus its first iteration and the script ran toward 1,095 s of its
# 1,200 s limit; at nbath 5 (its fit alone 25.5 s) the script took 1,050 s
DMFT_NBATH = 4
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
# the ineq golden: the solve goldens' TOL for the first iteration, the DMFT
# golden's for the fit and the second iteration
# (a fitted bath is held at 1e-7, and the second iteration starts from it)
TOL_INEQ_LOOP2 = dict(TOL_DMFT, energies=TOL_DMFT["dens"])
# config 2's second site in the sweep (ineq (b)): Hloc -0.1 on both
# orbitals, Uloc 2.5
INEQ_SITE2_HLOC = -0.1
INEQ_SITE2_ULOC = 2.5
SUMRULE_TOL = 1e-10       # GF weights of a diagonal channel sum to 1
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
    _native_report(report)


NATIVE_REPS = 20          # timed passes over config 3's registers


def _enumerate_all(registers) -> float:
    """Seconds of NATIVE_REPS passes of fock.enumerate_states over
    ``registers`` ((ns, n) pairs), its cache cleared before each pass."""
    from edipack_tpu_torch import fock
    t0 = time.perf_counter()
    for _ in range(NATIVE_REPS):
        fock.enumerate_states.cache_clear()
        for ns, n in registers:
            fock.enumerate_states(ns, n)
    return (time.perf_counter() - t0) / NATIVE_REPS


def _native_report(report: dict) -> None:
    """(f) the native host library: which enumeration runs, native against
    NumPy (EDIPACK_TPU_TORCH_NO_NATIVE=1) over config 3's registers (the
    ten-level spin registers and the twenty-level joint one of its Sz=0
    sector), both equal, and the enumeration's share of config 3's
    largest joint host build (Sz=0, 184,756 states: its basis and
    build_joint_sector_op, cold caches; the enumeration's time from
    cProfile)."""
    import cProfile
    import pstats
    from edipack_tpu_torch import fock, native
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.joint import build_joint_sector_op
    from edipack_tpu_torch.profile_solve import CONFIG3
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    t0 = time.perf_counter()
    on = native.available()
    load_s = time.perf_counter() - t0
    if not on:
        fail(f"native: the host library is off ({native.NO_NATIVE_ENV} is "
             f"set)")
    registers = [(10, n) for n in range(11)] + [(20, 10)]
    nat = _enumerate_all(registers)
    arrays = [fock.enumerate_states(*r) for r in registers]
    os.environ[native.NO_NATIVE_ENV] = "1"
    try:
        npy = _enumerate_all(registers)
        same = all(np.array_equal(fock.enumerate_states(*r), a)
                   for r, a in zip(registers, arrays))
    finally:
        del os.environ[native.NO_NATIVE_ENV]
        fock.enumerate_states.cache_clear()
    cfg = default_config(**CONFIG3, ed_verbose=0)
    terms = (np.zeros((1, 1, 2, 2)), build_umatrix(cfg), init_bath(cfg))

    def host_build():
        """Sz=0's basis (a new Sector: its states enumerated anew) and its
        operator's host build."""
        sec = SectorTable(cfg).by_qn(("sz", 0))
        build_joint_sector_op(cfg, sec, *terms)
        return sec.dim
    t0 = time.perf_counter()
    dim = host_build()
    build_s = time.perf_counter() - t0
    fock.enumerate_states.cache_clear()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(host_build)
    prof_s = time.perf_counter() - t0
    enum_s = sum(st[3] for (path, _, fn), st in
                 pstats.Stats(prof).stats.items()
                 if fn == "enumerate_states" and path.endswith("fock.py"))
    report["native"] = dict(available=on, load_s=load_s, native_ms=nat * 1e3,
                            numpy_ms=npy * 1e3, build_s=build_s,
                            build_profiled_s=prof_s, enumerate_s=enum_s,
                            share=enum_s / prof_s, sector=dim)
    print(f"[build] (f) native host library: available {on} "
          f"({native.library_path().relative_to(ROOT)}, g++ and load "
          f"{load_s:.2f} s); config 3's registers (10 bits, n = 0..10, and "
          f"20 bits, n = 10) enumerated in {nat * 1e3:.3f} ms natively, "
          f"{npy * 1e3:.3f} ms by NumPy, equal {same}; config 3's Sz=0 "
          f"basis and host build ({dim} states) {build_s:.3f} s cold, under "
          f"cProfile {prof_s:.3f} s, of it "
          f"the enumeration {enum_s * 1e3:.3f} ms, a share of "
          f"{enum_s / prof_s:.2e}")
    if not same:
        fail("native: the native and NumPy enumerations differ")


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


TRACE_CONFIG = dict(norb=1, nbath=4, nspin=1, uloc=[2.0], xmu=1.0)
TRACE_TOL = 1e-12         # the traced solve against the untraced one


def phase_trace(report: dict) -> None:
    """Config 1 solved without and with ed_profile_dir: the trace file, its
    CUDA kernel events, and the same results."""
    import shutil
    import edipack_tpu_torch as ed
    out = os.path.join(ROOT, "build", "chip_smoke_trace")
    shutil.rmtree(out, ignore_errors=True)
    got = {}
    for label, kw in (("untraced", {}), ("traced", dict(ed_profile_dir=out))):
        cfg = ed.default_config(**TRACE_CONFIG, ed_verbose=0, **kw)
        ed.set_config(cfg)
        bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
        ed.ed_set_hloc(np.zeros((1, 1, 1, 1)))
        t0 = time.perf_counter()
        res = ed.ed_solve(bath)
        wall = time.perf_counter() - t0
        got[label] = dict(e0=np.asarray(res.e0), gimp=ed.ed_get_gimp(
            _z(cfg.beta)), dens=np.asarray(ed.ed_get_dens()),
            docc=np.asarray(ed.ed_get_docc()))
        ed.ed_finalize_solver()
        print(f"[trace] config 1 {label}: wall {wall:.2f} s (the traced "
              f"one includes writing the trace), e0 {res.e0:.12f}")
    files = os.listdir(out) if os.path.isdir(out) else []
    if len(files) != 1:
        fail(f"trace: {len(files)} files under {out}, not one")
    path = os.path.join(out, files[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dev = max(float(np.max(np.abs(got["traced"][k] - got["untraced"][k])))
              for k in got["traced"])
    print(f"[trace] {os.path.relpath(path, ROOT)}: {os.path.getsize(path)} "
          f"bytes, {len(events)} events, {len(kernels)} CUDA kernel events"
          f" ({len({e['name'] for e in kernels})} kernels); traced vs "
          f"untraced {dev:.3e} (limit {TRACE_TOL})")
    if not kernels:
        fail("trace: no CUDA kernel event in the trace")
    if not dev <= TRACE_TOL:
        fail(f"trace: the traced solve differs by {dev:.3e}")


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
    report["e77"] = e77
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
    # the lone solve that site 1 of the ineq phase's sweep is held to
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
    """(a) the n2b4 DMFT golden; (b) the second DMFT iteration of config 2
    cut to DMFT_NBATH bath levels, from the restart files its first
    iteration (a cold f64 solve) writes."""
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
    cfg1 = ed.default_config(norb=2, nbath=DMFT_NBATH, nspin=1, ed_verbose=0,
                             ed_fused_matvec="always", **KANAMORI)
    bath = ed.ed_init_solver(cfg=cfg1, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    res1, _, wall1 = _solve_once(f"config 2 at nbath={DMFT_NBATH}, DMFT "
                                 f"loop 1 f64", cfg1, bath)
    ed.ed_finalize_solver()
    loop1 = dict(cfg=cfg1, res=res1, wall=wall1)
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
        print(f"[dmft] nbath={DMFT_NBATH} fit (host CPU, {len(idx)} parameters, lfit "
              f"{cfg.lfit}, cg_method {cfg.cg_method}): {fit_s:.2f} s "
              f"({fit_s / loop1['wall']:.3f} of loop 1's solve), chi2 "
              f"{chi_before:.6e} -> {chi_after:.6e}; chi2 and gradient "
              f"{eval_ms:.3f} ms an evaluation, so about "
              f"{fit_s / eval_ms * 1e3:.0f} evaluations")
        if not (np.all(np.isfinite(bath2)) and chi_after < chi_before):
            fail(f"DMFT fit: chi2 {chi_before:.3e} -> {chi_after:.3e}")
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
        res2, counts, wall = _solve_once(f"config 2 at nbath={DMFT_NBATH}, "
                                         f"DMFT loop 2 f64", cfg, None)
        print(f"[dmft]   neigen_sector from state_list.restart: "
              f"{sorted(set(neigen.tolist()))} (loop 1: "
              f"{cfg.lanc_nstates_sector}); loop 1 wall {loop1['wall']:.2f} "
              f"s, {res1.n_matvecs} matvecs")
        bad = _lanczos_nev(res2, neigen)
        if bad:
            fail(f"loop 2 did not take neigen from state_list.restart: {bad}")
        if counts["B1"] <= 0:
            fail("DMFT loop 2 did not launch B1")
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


def _extras_checks(res, label: str) -> None:
    """The extras identities at config 2's width on one solve's result:
    each χ channel's + weights against Σ w‖Oψ‖² (and, for spin and dens,
    the solve's dens and docc), the first moments of the spin and pair
    channels of orbital 0 against KronMatvec, and the RDM's identities."""
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
        print(f"[extras]   {label} sum rule {key}: + weights {got:.12f}, "
              f"Σ w‖Oψ‖² {ref:.12f}{extra}")
    print(f"[extras]   {label} sum rules: worst rel {worst:.3e} (limit "
          f"{IDENTITY_RTOL})")
    if not worst <= IDENTITY_RTOL:
        fail(f"{label} chi sum rules off by {worst:.3e}")
    for key in (("spin", 0, 0), ("pair", 0, 0)):
        got, want, scale = _first_moment(res, key)
        rel = abs(got - want) / scale
        print(f"[extras]   {label} first moment {key}: Σ weight × pole "
              f"{got:.12e}, KronMatvec {want:.12e}, rel to {scale:.6e}: "
              f"{rel:.3e} (limit {IDENTITY_RTOL})")
        if not rel <= IDENTITY_RTOL:
            fail(f"{label} chi first moment {key} off by {rel:.3e}")
    _rdm_checks(res)


def phase_extras(report: dict) -> None:
    # (b), config 2 with the extras, runs on the sweep's sites (phase ineq)
    _extras_golden(report)


# ---------------------------------------------------------------------------
# phase ineq: inequivalent sites (EDIneqSolver) — normal-mode sites as one
# site-batched sweep through B1, superc sites one after another
# ---------------------------------------------------------------------------


def _site_hloc(norb: int, values) -> np.ndarray:
    return np.stack([np.eye(norb)[None, None] * v for v in values])


def _ineq_check(tag: str, solver, recs: list, z, keys, tol: dict) -> None:
    """Every site's result against the golden records ``recs``."""
    g = solver.get_gimp(z) if "gimp" in keys else None
    sig = solver.get_sigma(z) if "sigma" in keys else None
    for n, (s, want) in enumerate(zip(solver.solvers, recs)):
        res = s.result
        got = dict(e0=res.e0, evals=np.asarray(res.evals), dens=res.dens,
                   docc=res.docc, energies=res.energies)
        for k in keys:
            ref = _cplx(want[k]) if k in ("gimp", "sigma") else want[k]
            val = {"gimp": g, "sigma": sig}[k][n] if k in ("gimp", "sigma") \
                else got[k]
            _check_close(f"{tag} site {n} {k}", val, ref,
                         tol["e0" if k == "evals" else k])


def _ineq_golden(report: dict) -> None:
    """(a) tests/data/torch_port_golden_ineq.json: three n2b4 sites through
    B1 (full call, fit_gf, second iteration; the statics-only call is
    held by tests/test_torch_ineq.py::test_ineq_solver_against_jax), then
    two superc sites through the per-site loop."""
    import torch
    import edipack_tpu_torch as ed
    with open(GOLDEN_INEQ) as fh:
        gold = json.load(fh)
    cfg = ed.set_config(ed.default_config(**gold["config"], ed_verbose=0,
                                          ed_fused_matvec="always"))
    z = _z(cfg.beta)
    solver = ed.EDIneqSolver(len(gold["hloc"]), cfg, device=DEVICE)
    baths = solver.init_solver()
    if not np.array_equal(baths, np.asarray(gold["bath"])):
        fail("ineq golden: the default baths differ from the file's")
    solver.set_hloc(_site_hloc(cfg.norb, gold["hloc"]))
    over = dict(uloc_ii=np.array(gold["uloc_ii"]),
                ust_ii=np.array(gold["ust_ii"]))
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    solver.solve(baths, **over)
    _ineq_check("ineq loop 1", solver, gold["loop1"], z,
                ("e0", "evals", "dens", "docc", "energies", "gimp", "sigma"),
                TOL)
    t2 = time.perf_counter()
    fit = solver.fit_gf((WBAND / 2.0) ** 2 * solver.get_gimp(), baths)
    _check_close("ineq fitted baths", fit, np.asarray(gold["fit"]),
                 TOL_DMFT["bath"])
    t3 = time.perf_counter()
    solver.solve(fit)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    n = read_counts()["B1"]
    _ineq_check("ineq loop 2", solver, gold["loop2"], z,
                ("e0", "dens", "docc", "energies", "gimp", "sigma"),
                TOL_INEQ_LOOP2)
    print(f"[ineq] (a) three n2b4 sites: full sweep {t2 - t1:.2f} s, "
          f"fit_gf {t3 - t2:.2f} s, second "
          f"sweep {t4 - t3:.2f} s; B1 launches {n}; matvecs per site "
          f"{[s.result.n_matvecs for s in solver.solvers]}")
    if n <= 0:
        fail("ineq golden: no B1 launch")
    report["B1_launches_ineq_golden"] = n
    solver.finalize()
    sc = gold["superc"]
    cfg = ed.set_config(ed.default_config(**sc["config"], ed_verbose=0))
    solver = ed.EDIneqSolver(len(sc["hloc"]), cfg, device=DEVICE)
    baths = solver.init_solver()
    solver.set_hloc(_site_hloc(cfg.norb, sc["hloc"]))
    t0 = time.perf_counter()
    solver.solve(baths, uloc_ii=np.array(sc["uloc_ii"]))
    g, f = solver.get_gimp(z), solver.get_gimp(z, typ="a")
    for n, (s, want) in enumerate(zip(solver.solvers, sc["sites"])):
        res = s.result
        for k, val in (("e0", res.e0), ("dens", res.dens),
                       ("docc", res.docc), ("phi", res.phisc),
                       ("gimp", g[n]), ("impf", f[n])):
            ref = _cplx(want[k]) if k in ("gimp", "impf") else want[k]
            _check_close(f"ineq superc site {n} {k}", val, ref,
                         TOL_CROSS[k])
    print(f"[ineq] (a) two superc sites (per-site loop): "
          f"{time.perf_counter() - t0:.2f} s")
    solver.finalize()


def _gf_weight_sums(res) -> float:
    """The worst |Σw - 1| over the diagonal channels of the normal GF."""
    keys = [k for k in res.gf.channels if k[0] == "g" and k[2] == k[3]]
    if not keys:
        fail("no diagonal GF channel")
    return max(abs(float(np.real(res.gf.packed(k)[0].sum())) - 1.0)
               for k in keys)


def _ineq_config2(report: dict) -> None:
    """(b) EDIneqSolver(2) at config 2's width in one sweep, with the χ
    flags and rdm_flag: site 1 is config 2 (held to phase_solve's f64
    solve), site 2 has Hloc -0.1 and Uloc 2.5 (its ground sector re-solved
    through KronMatvec); the GF weights of both; the extras identities on
    both sites and the Krylov state complexity of site 1."""
    import torch
    import edipack_tpu_torch as ed
    from edipack_tpu_torch.bath.dmft_bath import bath_to_array
    from edipack_tpu_torch.models.normal import build_normal_sector_op
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.ops.matvec import KronMatvec
    from edipack_tpu_torch.solver import core
    from edipack_tpu_torch.solver.krylov import krylov_state_complexity
    ref = report["loop1"]["res"]
    cfg = ed.set_config(ed.default_config(norb=2, nbath=6, nspin=1,
                                          ed_verbose=0, **KANAMORI,
                                          **CHI_FLAGS))
    solver = ed.EDIneqSolver(2, cfg, device=DEVICE)
    baths = solver.init_solver()
    if not np.array_equal(baths[0], bath_to_array(ref.bath)):
        fail("ineq config 2: site 1's bath is not config 2's")
    solver.set_hloc(_site_hloc(2, [0.0, INEQ_SITE2_HLOC]))
    uloc = np.array([KANAMORI["uloc"], [INEQ_SITE2_ULOC] * 2])
    # B1 launches of the χ phases: read around build_chi_normal
    chi_counts = [0]
    build_chi = core.build_chi_normal

    def counted(*args, **kw):
        before = read_counts()["B1"]
        try:
            return build_chi(*args, **kw)
        finally:
            chi_counts[0] += read_counts()["B1"] - before

    core.build_chi_normal = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = solver.solve(baths, uloc_ii=uloc)
        torch.cuda.synchronize()
    finally:
        core.build_chi_normal = build_chi
    wall = time.perf_counter() - t0
    n = read_counts()["B1"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for s, res in enumerate(results):
        print(f"[ineq] (b) site {s + 1}: e0 {res.e0:.12f}, matvecs "
              f"{res.n_matvecs}, phases " + ", ".join(
                  f"{k} {v:.2f} s" for k, v in res.timings.items()))
    print(f"[ineq] (b) config 2 two-site sweep: wall {wall:.2f} s (phase_"
          f"solve's lone f64 solve {report['loop1']['wall']:.2f} s); B1 "
          f"launches {n} (of them the chi phases {chi_counts[0]}); peak "
          f"device memory {peak:.2f} GiB")
    if n <= 0 or chi_counts[0] <= 0:
        fail(f"ineq config 2: B1 launches {n}, chi phases {chi_counts[0]}")
    z = _z(cfg.beta)
    site1 = results[0]
    for k, got, want in (("e0", site1.e0, ref.e0),
                         ("dens", site1.dens, ref.dens),
                         ("docc", site1.docc, ref.docc),
                         ("gimp", site1.get_gimp(z), ref.get_gimp(z))):
        _check_close(f"ineq config 2 site 1 vs the lone solve {k}", got,
                     want, TOL[k])
    site2 = results[1]
    st = site2.diag.state_list.states[0]
    for other in site2.diag.state_list.states:
        if other.energy < st.energy:
            st = other
    sec = site2.table.sector(st.sector)
    mv = KronMatvec(build_normal_sector_op(site2.cfg, sec, site2.hloc,
                                           site2.um, site2.bath),
                    torch.device(DEVICE))
    vals, _ = eigsh_lowest(mv, mv.dim, 1, tol=1e-14)
    dev_e0 = abs(float(vals[0]) - site2.e0)
    print(f"[ineq] (b) site 2 ground-state sector {sec.qn} dim {sec.dim}: "
          f"KronMatvec e0 {vals[0]:.12f}, sweep e0 {site2.e0:.12f}, |diff| "
          f"{dev_e0:.3e} (limit {TOL['e0']})")
    if not dev_e0 <= TOL["e0"]:
        fail(f"ineq config 2 site 2: e0 off KronMatvec's by {dev_e0:.3e}")
    del mv
    for s, res in enumerate(results):
        dev = _gf_weight_sums(res)
        print(f"[ineq] (b) site {s + 1}: GF weights per diagonal channel, "
              f"worst |Σw - 1| {dev:.3e} (limit {SUMRULE_TOL})")
        if not dev <= SUMRULE_TOL:
            fail(f"ineq config 2 site {s + 1}: GF weights off by {dev:.3e}")
    for s, res in enumerate(results):
        _extras_checks(res, f"config 2 site {s + 1}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kr = krylov_state_complexity(site1)
    torch.cuda.synchronize()
    kry_s = time.perf_counter() - t0
    kry = read_counts()["B1"]
    worst_p = max(float(np.abs(p.sum(0) - 1.0).max())
                  for p in kr.distribution.values())
    k0 = max(abs(float(k[0])) for k in kr.complexity.values())
    print(f"[extras]   config 2 site 1 Krylov state complexity: {kry_s:.2f} "
          f"s, B1 launches {kry}, keys {sorted(kr.complexity)}; "
          f"distribution sums to 1 within {worst_p:.3e} (limit {RDM_TOL}), "
          f"|K(0)| {k0:.3e}; K(tmax) " + ", ".join(
              f"{k}: {v[-1]:.6f}" for k, v in sorted(kr.complexity.items())))
    if not (worst_p <= RDM_TOL and k0 <= RDM_TOL and kry > 0):
        fail("config 2 Krylov state complexity")
    report["B1_launches_ineq"] = n
    report["B1_launches_extras"] = chi_counts[0] + kry
    report["ineq"] = dict(wall_s=wall, krylov_s=kry_s, peak_gib=peak,
                          timings=[r.timings for r in results])
    solver.finalize()
    del report["loop1"]


def phase_ineq(report: dict) -> None:
    t0 = time.perf_counter()
    _ineq_golden(report)
    print(f"[ineq] (a) golden in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    _ineq_config2(report)
    print(f"[ineq] (b) config 2 sweep and its checks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase capi: the C library (edipack_tpu_torch/capi) and two C drivers
# ---------------------------------------------------------------------------

CAPI_DRIVERS = ("edtpu_lattice", "compat_lattice")
CAPI_BAD_DEVICE = "cpu'); import os; ('"
# the C example's problem (examples/c/hm_bethe.c), for the Python path
HM_BETHE = dict(norb=1, nbath=5, nspin=1, beta=100.0, lmats=512, lfit=512,
                uloc=[2.0], xmu=0.0, cg_scheme="delta", cg_niter=600)
HM_BETHE_LOOPS = 2


def _capi_run(exe: str, args, env: dict, cwd=None) -> tuple:
    t0 = time.perf_counter()
    out = subprocess.run([exe, *map(str, args)], capture_output=True,
                         text=True, env=env, timeout=600, cwd=cwd)
    return out, time.perf_counter() - t0


def _hm_bethe_python() -> float:
    """Loop 1's density of the C example's problem through ed_solve."""
    import edipack_tpu_torch as ed
    cfg = ed.default_config(**HM_BETHE, ed_verbose=0)
    ed.set_config(cfg)
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(np.zeros((1, 1, 1, 1)))
    ed.ed_solve(bath)
    dens = float(ed.ed_get_dens()[0])
    ed.ed_finalize_solver()
    return dens


def _check_hm_bethe(out, wall: float, log: str, dens_py: float) -> None:
    import re
    if out.returncode != 0 or "Traceback" in out.stderr:
        fail(f"capi hm_bethe: rc {out.returncode}\n{out.stdout[-2000:]}"
             f"\n{out.stderr[-4000:]}")
    with open(log) as fh:
        launched = json.load(fh)
    loops = re.findall(r"loop +(\d+) +err (\S+) +dens (\S+)", out.stdout)
    print(f"[capi] hm_bethe (the C example, {HM_BETHE_LOOPS} loops): wall "
          f"{wall:.2f} s, loops {loops}, kernel launches {launched}; the "
          f"Python path's loop 1 density {dens_py:.6f}")
    if [int(n) for n, _, _ in loops] != list(range(1, HM_BETHE_LOOPS + 1)) \
            or not all(np.isfinite(float(x)) for _, e, d in loops
                       for x in (e, d)):
        fail(f"capi hm_bethe: loops {loops}")
    # equal at the printed precision (%.6f): within half its last digit
    if not abs(float(loops[0][2]) - dens_py) <= 5e-7:
        fail(f"capi hm_bethe: loop 1 density {loops[0][2]}, the Python "
             f"path's {dens_py:.9f}")


def phase_capi(report: dict) -> None:
    """Build libedipack_tpu_torch_c.so and the edtpu_* and reference-ABI
    lattice drivers (capi/drivers/), run both at the ineq golden's two-site
    case on the card through B1 (at once, with a run under a bad
    EDIPACK_TPU_TORCH_DEVICE, which must fail edtpu_init with its
    message), and hold their printed numbers to the golden; a traceback on
    a driver's stderr fails."""
    import shutil
    import sysconfig
    from edipack_tpu_torch.capi import build
    inc = build.python_include()
    print(f"[capi] python {sysconfig.get_config_var('VERSION')}: Python.h "
          f"under {inc}: {(inc / 'Python.h').exists()}; gcc "
          f"{shutil.which('gcc')}")
    t0 = time.perf_counter()
    lib = build.build()
    print(f"[capi] {lib.relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s (gcc {build.build_seconds:.2f} "
          f"s)")
    with open(GOLDEN_INEQ) as fh:
        gold = json.load(fh)["capi"]
    work = os.path.join(ROOT, "build", "chip_smoke_capi")
    os.makedirs(work, exist_ok=True)
    exes = {}
    t0 = time.perf_counter()
    for name in CAPI_DRIVERS:
        exes[name] = os.path.join(work, name)
        out = subprocess.run(
            ["gcc", "-O2", *build.include_flags(), "-o", exes[name],
             os.path.join(build.CAPI_DIR, "drivers", name + ".c"),
             *build.link_flags(lib)], capture_output=True, text=True)
        if out.returncode != 0:
            fail(f"capi: driver {name} does not build:\n{out.stderr}")
    from edipack_tpu_torch.examples.c import build as example
    exes["hm_bethe"] = str(example.build())
    print(f"[capi] drivers and the C example built in "
          f"{time.perf_counter() - t0:.2f} s")
    config = dict(gold["config"], ed_fused_matvec="always", ed_verbose=0)
    path_in = os.path.join(work, "inputED.in")
    with open(path_in, "w") as fh:
        for k, v in config.items():
            v = ",".join(map(str, v)) if isinstance(v, list) else v
            fh.write(f"{k.upper()}={v}\n")
    cfg_norb, lm, nlat = config["norb"], config["lmats"], gold["nlat"]
    args = {"edtpu_lattice": (path_in, config.get("nspin", 1), cfg_norb, lm,
                              nlat, gold["hstag"]),
            "compat_lattice": (path_in, nlat, gold["hstag"])}
    # the two drivers and the bad-device run at once, each in a process of
    # its own on the one card (their solves are mostly host work)
    from concurrent.futures import ThreadPoolExecutor
    logs = {name: os.path.join(work, name + ".launches.json")
            for name in (*CAPI_DRIVERS, "hm_bethe")}
    env = dict(os.environ, PYTHONPATH=ROOT, EDIPACK_TPU_TORCH_DEVICE="cuda")
    for log in logs.values():
        if os.path.exists(log):
            os.remove(log)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CAPI_DRIVERS) + 2) as pool:
        runs = {name: pool.submit(_capi_run, exes[name], args[name], dict(
            env, EDIPACK_TPU_TORCH_LAUNCH_LOG=logs[name]))
                for name in CAPI_DRIVERS}
        bad = pool.submit(_capi_run, exes["edtpu_lattice"],
                          args["edtpu_lattice"],
                          dict(env, EDIPACK_TPU_TORCH_DEVICE=CAPI_BAD_DEVICE))
        hm = pool.submit(_capi_run, exes["hm_bethe"], [HM_BETHE_LOOPS],
                         dict(env, EDIPACK_TPU_TORCH_LAUNCH_LOG=logs[
                             "hm_bethe"]), work)
        dens_py = _hm_bethe_python()
        runs = {name: f.result() for name, f in runs.items()}
        bad = bad.result()
        hm = hm.result()
    print(f"[capi] the two drivers, the bad-device run and the C example "
          f"together: {time.perf_counter() - t0:.2f} s")
    _check_hm_bethe(*hm, logs["hm_bethe"], dens_py)
    total = 0
    for name in CAPI_DRIVERS:
        out, wall = runs[name]
        if out.returncode != 0 or "Traceback" in out.stderr:
            fail(f"capi {name}: rc {out.returncode}\n{out.stdout[-2000:]}"
                 f"\n{out.stderr[-4000:]}")
        vals = {}
        for line in out.stdout.splitlines():
            key, cnt, *rest = line.split()
            vals[key] = np.array([float(x) for x in rest])
            if len(rest) != int(cnt):
                fail(f"capi {name}: bad line {line[:80]}")
        with open(logs[name]) as fh:
            launched = json.load(fh)
        order = "C" if name == "edtpu_lattice" else "F"
        g = vals["G"][0::2] + 1j * vals["G"][1::2]
        for key, got, want, tol in (
                ("dens", vals["DENS"].reshape(nlat, cfg_norb, order=order),
                 gold["dens"], TOL["dens"]),
                ("docc", vals["DOCC"].reshape(nlat, cfg_norb, order=order),
                 gold["docc"], TOL["docc"]),
                ("energies", vals["EIMP"].reshape(nlat, 4, order=order),
                 gold["eimp"], TOL["energies"]),
                ("gimp", g.reshape(nlat, 1, 1, cfg_norb, cfg_norb, lm,
                                   order=order),
                 _cplx(gold["gimp"]), TOL["gimp"])):
            _check_close(f"capi {name} {key}", got, np.asarray(want), tol)
        print(f"[capi] {name}: wall {wall:.2f} s, kernel launches "
              f"{launched}, stderr {len(out.stderr)} bytes without a "
              f"traceback")
        if launched["B1"] <= 0:
            fail(f"capi {name}: no B1 launch")
        total += launched["B1"]
    report["B1_launches_capi"] = total
    out, wall = bad
    print(f"[capi] EDIPACK_TPU_TORCH_DEVICE={CAPI_BAD_DEVICE!r}: rc "
          f"{out.returncode}, {out.stdout.strip()[:160]!r} ({wall:.2f} s)")
    if out.returncode == 0 or "is not one of" not in out.stdout:
        fail("capi: a bad EDIPACK_TPU_TORCH_DEVICE was not refused")


# ---------------------------------------------------------------------------
# joint modes (superc / nonsu2): no TPU kernel is on this path (the JAX
# joint operators are plain jnp); the card runs the port's PyTorch ELL,
# direct and blocked-Kron operators in complex128
# ---------------------------------------------------------------------------

JOINT_ROUTES = (("ell", {}), ("direct", dict(ed_sparse_h=False)),
                ("kron", dict(ed_joint_kron="always")))
# configs 3 and 4: the two routes against each other (e0 1e-10, G, F, φ
# 1e-8), each kept state's residual through the other route's operator
# (relative to |E|), and the normal GF's weights summing to 1 per channel.
# The residual limit: members of config 4's degenerate ground multiplets
# come out of Lanczos at the restart cap with ‖Hψ - Eψ‖/|E| ~ 2e-9
# (their energies still agree to 1e-14)
TOL_CROSS = dict(e0=1e-10, gimp=1e-8, impf=1e-8, phi=1e-8, dens=1e-8,
                 docc=1e-8)
RESID_RTOL = 1e-8
JOINT_RTOL = 1e-12        # the 2.7M-state operators against each other
# configs 3 and 4 (CONFIG3, CONFIG4, their levels a sector JOINT_NEV and
# config 4's spin-mixing Hloc) are edipack_tpu_torch/profile_solve.py's


def _joint_golden(report: dict) -> None:
    """(a) every case of the joint golden through the three routes."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import joint_cases as jc
    with open(os.path.join(DATA, "torch_port_golden_joint.json")) as fh:
        gold = json.load(fh)
    pkg = jc.modules("edipack_tpu_torch")
    walls = {}
    for name, case in jc.CASES.items():
        for route, kw in JOINT_ROUTES:
            t0 = time.perf_counter()
            got = jc.run_case(pkg, case, device=DEVICE, **kw)
            walls[f"{name}/{route}"] = time.perf_counter() - t0
            want = jc.from_json(gold["cases"][name], got)
            dev = jc.deviations(got, want)
            print(f"[joint] golden {name:14s} {route:6s} "
                  f"{walls[f'{name}/{route}']:6.2f} s: "
                  + ", ".join(f"{k} {v:.1e}" for k, v in dev.items()))
            bad = {k: v for k, v in dev.items() if not v <= jc.TOL[k]}
            if bad:
                fail(f"joint golden {name} via {route}: {bad}")
    report["joint_golden_s"] = walls


def _joint_solve(label: str, config: dict, hloc, route: dict):
    """One cold ed_solve of ``config`` on the card; its result, wall and a
    summary printed."""
    import torch
    import edipack_tpu_torch as ed
    from edipack_tpu_torch.profile_solve import JOINT_NEV
    cfg = ed.default_config(**config, ed_verbose=0,
                            lanc_nstates_sector=JOINT_NEV, **route)
    ed.set_config(cfg)
    bath = ed.ed_init_solver(cfg=cfg, device=DEVICE)
    ed.ed_set_hloc(hloc)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the reserved peak is then this solve's
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ed.ed_solve(bath)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    z = _z(cfg.beta)
    out = dict(res=res, wall=wall, e0=res.e0, gimp=ed.ed_get_gimp(z),
               dens=np.asarray(ed.ed_get_dens()),
               docc=np.asarray(ed.ed_get_docc()))
    if cfg.ed_mode == "superc":
        out.update(impf=ed.ed_build_impf(z), phi=np.asarray(ed.ed_get_phi()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    held = torch.cuda.max_memory_reserved() / 2**30
    big = max(res.table.get_dim(i) for i in range(len(res.table)))
    print(f"[joint] {label}: wall {wall:.2f} s, phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res.timings.items())
          + f"; e0 {res.e0:.12f}, kept {len(res.evals)}, matvecs "
          f"{res.n_matvecs}, largest sector {big}, Lanczos sectors "
          f"{len(res.diag.lanczos_stats)}, peak device memory {peak:.2f} GiB"
          f" allocated (its CUDA graphs' pools included), {held:.2f} GiB "
          f"reserved")
    kept: dict = {}
    for st in res.diag.state_list:
        kept.setdefault(st.sector, []).append(st.energy - res.e0)
    print(f"[joint]   kept (sector, E - e0): "
          + "; ".join(f"{res.table.sector(i).qn[1:]} "
                      + ", ".join(f"{e:.2e}" for e in es)
                      for i, es in sorted(kept.items())))
    for i, es in kept.items():
        if len(res.diag.evals_by_sector[i]) <= len(es):
            fail(f"{label}: sector {res.table.sector(i).qn} kept all "
                 f"{len(es)} levels it found; its multiplet may be "
                 f"incomplete")
    for name, arr in out.items():
        if name not in ("res", "wall") and not np.all(np.isfinite(arr)):
            fail(f"{label}: {name} is not finite")
    ed.ed_finalize_solver()
    return out


def _other_operator(res, route: dict):
    """A sector -> matvec builder of ``res``'s problem through ``route``,
    in the sorted joint basis."""
    import torch
    from edipack_tpu_torch.solver.core_joint import joint_builders
    cfg = res.cfg.replace(**route)
    b = joint_builders(cfg, res.table, res.hloc, res.um, res.bath,
                       torch.device(DEVICE), res.hloc_anomalous)

    def apply(sec, v):
        mv = b.matvec_builder(sec)
        if hasattr(mv, "to_internal_flat"):
            return mv.from_internal_flat(mv(mv.to_internal_flat(v)))
        return mv(v)
    return apply


def _cross_check(label: str, a: dict, b: dict, route_b: dict) -> None:
    """Two routes' solves of one configuration against each other, the
    kept states of ``a`` through ``b``'s operator, and the weight sum
    rules of ``a``'s normal GF."""
    import torch
    for k, tol in TOL_CROSS.items():
        if k not in a:
            continue
        dev = float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
        print(f"[joint]   {label} routes agree: {k} {dev:.3e} (limit {tol})")
        if not dev <= tol:
            fail(f"{label}: {k} of the two routes differ by {dev:.3e}")
    res = a["res"]
    apply = _other_operator(res, route_b)
    worst = 0.0
    for st in res.diag.state_list:
        sec = res.table.sector(st.sector)
        v = st.vector.to(torch.complex128)
        r = apply(sec, v) - st.energy * v
        worst = max(worst, float(torch.linalg.norm(r)
                                 / torch.linalg.norm(v)) / abs(st.energy))
    print(f"[joint]   {label}: {len(res.evals)} kept states through the "
          f"other route's operator, worst ‖Hψ - Eψ‖/|E| {worst:.3e} "
          f"(limit {RESID_RTOL})")
    if not worst <= RESID_RTOL:
        fail(f"{label}: kept-state residual {worst:.3e}")
    keys = [k for k in res.gf.channels if k[0] == "g"]
    sums = {k: float(np.real(res.gf.packed(k)[0].sum())) for k in keys}
    dev = max(abs(v - 1.0) for v in sums.values())
    print(f"[joint]   {label}: normal GF weights per channel "
          + ", ".join(f"{k[1:]} {v:.12f}" for k, v in sorted(sums.items(),
                                                           key=str))
          + f"; worst |Σw - 1| {dev:.3e} (limit {SUMRULE_TOL})")
    if not (keys and dev <= SUMRULE_TOL):
        fail(f"{label}: GF spectral weights off by {dev:.3e}")


def _joint_configs(report: dict) -> None:
    """(b) config 3 through ELL and blocked-Kron; (c) config 4 through ELL
    and direct."""
    from edipack_tpu_torch.profile_solve import (CONFIG3, CONFIG4,
                                                 spin_mixing_hloc)
    kron = dict(ed_joint_kron="always")
    direct = dict(ed_sparse_h=False)
    c3 = dict(ell=_joint_solve("config 3 superc, ELL", CONFIG3,
                               np.zeros((1, 1, 2, 2)), {}),
              kron=_joint_solve("config 3 superc, blocked-Kron", CONFIG3,
                                np.zeros((1, 1, 2, 2)), kron))
    _cross_check("config 3", c3["ell"], c3["kron"], kron)
    _cross_check("config 3 (Kron states)", c3["kron"], c3["ell"],
                 dict(ed_joint_kron="auto"))
    h4 = spin_mixing_hloc(2)
    c4 = dict(ell=_joint_solve("config 4 nonsu2, ELL", CONFIG4, h4, {}),
              direct=_joint_solve("config 4 nonsu2, direct", CONFIG4, h4,
                                  direct))
    _cross_check("config 4", c4["ell"], c4["direct"], direct)
    _cross_check("config 4 (direct states)", c4["direct"], c4["ell"],
                 dict(ed_sparse_h=True))
    report["config3"] = {k: dict(wall_s=v["wall"], **v["res"].timings)
                         for k, v in c3.items()}
    report["config4"] = {k: dict(wall_s=v["wall"], **v["res"].timings)
                         for k, v in c4.items()}


def _big_sector(report: dict, mode: str, nbath: int = 5) -> None:
    """(d) one reference-scale joint sector (dim 2,704,156): the ELL, the
    blocked-Kron and a cuSPARSE complex128 CSR product timed and held to
    each other, then its lowest level by eigsh_lowest on the ELL."""
    import torch
    from edipack_tpu_torch.bath.dmft_bath import init_bath
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.models.joint import (_enumerate_joint_terms,
                                                build_joint_sector_op)
    from edipack_tpu_torch.models.joint_kron import (BlockedTermAccumulator,
                                                     JointKronMatvec)
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    from edipack_tpu_torch.profile_solve import (CONFIG3, CONFIG4,
                                                 spin_mixing_hloc)
    from edipack_tpu_torch.ops.matvec import JointMatvec
    from edipack_tpu_torch.sectors import SectorTable
    from edipack_tpu_torch.umatrix import build_umatrix
    dev = torch.device(DEVICE)
    base = CONFIG3 if mode == "superc" else CONFIG4
    cfg = default_config(**dict(base, nbath=nbath))
    table = SectorTable(cfg)
    sec = table.by_qn(("sz", 0) if mode == "superc"
                      else ("nt", table.dims.ns))
    hloc = np.zeros((1, 1, 2, 2)) if mode == "superc" \
        else spin_mixing_hloc(2)
    um, bath = build_umatrix(cfg), init_bath(cfg)
    t0 = time.perf_counter()
    op = build_joint_sector_op(cfg, sec, hloc, um, bath)
    t_coo = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = JointMatvec(op, dev)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = BlockedTermAccumulator(sec, sec.ns)
    _enumerate_joint_terms(cfg, sec, hloc, um, bath, None, acc, None)
    kb = JointKronMatvec(cfg, sec, acc, None, dev)
    torch.cuda.synchronize()
    t_kron = time.perf_counter() - t0
    # the same operator in gather groups of <= 6 terms (edipack_tpu's TPU
    # tuning; the port's default takes every term of a block pair at once)
    kb6 = JointKronMatvec(cfg, sec, acc, None, dev, gather_chunk=6)
    del acc
    dim, k = ell.dim, ell.k
    rows = np.concatenate([op.rows, np.arange(dim)])
    cols = np.concatenate([op.cols, np.arange(dim)])
    vals = np.concatenate([op.vals, op.diag.astype(complex)])
    csr = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([rows, cols]), device=dev),
        torch.as_tensor(vals, device=dev), (dim, dim)).coalesce() \
        .to_sparse_csr()
    nnz = int(csr.values().numel())
    del rows, cols, vals
    print(f"[joint] {mode} sector {sec.qn} at nbath={nbath}: dim {dim}, "
          f"nnz {nnz} "
          f"(ELL width {k}), {len(kb.blocks)} blocks, "
          f"{len(kb.el[3])} gather groups; host COO {t_coo:.2f} s, ELL "
          f"tables {t_ell:.2f} s, blocked-Kron {t_kron:.2f} s")
    g = torch.Generator().manual_seed(29)
    v = torch.complex(torch.randn(dim, generator=g, dtype=torch.float64),
                      torch.randn(dim, generator=g, dtype=torch.float64)
                      ).to(dev)
    ref = ell(v)
    errs = dict(kron=_rel(kb.from_internal_flat(
        kb(kb.to_internal_flat(v))), ref), csr=_rel(torch.mv(csr, v), ref))
    print(f"[joint]   against the ELL: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (limit {JOINT_RTOL})")
    if not max(errs.values()) <= JOINT_RTOL:
        fail(f"{mode} 2.7M sector: operators disagree {errs}")
    # the blocked Kron in its own layout, as a solve's Lanczos runs it
    kv = kb.to_internal_flat(v)
    fns = dict(ell=lambda: ell(v), kron_blocked=lambda: kb(kv),
               kron_chunk6=lambda: kb6(kv), csr=lambda: torch.mv(csr, v))
    e1 = _rel(kb6(kv), kb(kv))
    print(f"[joint]   blocked-Kron with {len(kb.el[3])} gather groups (one "
          f"a block pair) against {len(kb6.el[3])} groups of <= 6 terms: "
          f"{e1:.3e} (limit {JOINT_RTOL})")
    if not e1 <= JOINT_RTOL:
        fail(f"{mode} 2.7M sector: gather chunking changes H·v by {e1:.3e}")
    times = {}
    for n, f in fns.items():
        timed(times, n, f, reps=10)
    es = 16
    vbytes = 2 * es * dim
    blk = sum(8 * b.size for b in kb.blocks)
    for h in kb.el[1] + kb.el[2]:
        blk += 0 if h is None else es * h.numel()
    for (_, _, dwi, upi, wdw, us) in kb.el[3]:
        blk += 8 * (dwi.numel() + upi.numel() + us.numel()) + es * wdw.numel()
    mm = sum(8 * b.ddw * b.dup * ((b.dup if h1 is not None else 0)
                                  + (b.ddw if h2 is not None else 0))
             for b, h1, h2 in zip(kb.blocks, kb.el[1], kb.el[2]))
    bounds = dict(ell=bound(8 * nnz, vbytes + (4 + es) * dim * k, "f64"),
                  kron_blocked=bound(mm + 8 * nnz, vbytes + blk, "f64"),
                  csr=bound(8 * nnz, vbytes + 8 * (dim + 1)
                            + (8 + es) * nnz, "f64"))
    bounds["kron_chunk6"] = bounds["kron_blocked"]
    for n in ("ell", "kron_blocked", "kron_chunk6", "csr"):
        bd = bounds[n]
        print(f"[joint]   {n:12s} {times[n]:8.4f} ms flushed, "
              f"{times[n + '_b2b']:8.4f} ms back to back; bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['mbytes']:.1f}"
              f" MB, {bd['gflop']:.2f} GFLOP), share "
              f"{bd['bound_ms'] / times[n]:.3f}")
    print(f"[joint]   ELL / cuSPARSE c128: "
          f"{times['ell'] / times['csr']:.2f}x flushed; blocked-Kron / "
          f"cuSPARSE {times['kron_blocked'] / times['csr']:.2f}x")
    del csr, kb6
    t0 = time.perf_counter()
    stats: dict = {}
    vals_, vecs = eigsh_lowest(ell, dim, 1, dtype=torch.complex128, m=48,
                               tol=1e-12, max_restarts=40, stats=stats)
    torch.cuda.synchronize()
    t_eig = time.perf_counter() - t0
    psi = vecs[0]
    resid = float(torch.linalg.norm(ell(psi) - vals_[0] * psi)
                  / abs(vals_[0]))
    print(f"[joint]   lowest level by eigsh_lowest on the ELL: "
          f"{vals_[0]:.12f}, {t_eig:.2f} s, restarts {stats['n_restarts']}, "
          f"matvecs {stats['n_matvecs']}; ‖Hψ - Eψ‖/|E| {resid:.3e} (limit "
          f"{RESID_RTOL})")
    if not resid <= RESID_RTOL:
        fail(f"{mode} 2.7M sector: lowest level residual {resid:.3e}")
    report[f"big_{mode}"] = dict(dim=dim, nnz=nnz, k=k, t_coo=t_coo,
                                 t_ell=t_ell, t_kron=t_kron, t_eig=t_eig,
                                 e=float(vals_[0]), resid=resid,
                                 **times, **{f"bound_{n}": b["bound_ms"]
                                             for n, b in bounds.items()})


def phase_joint(report: dict) -> None:
    t0 = time.perf_counter()
    _joint_golden(report)
    print(f"[joint] (a) golden in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    _joint_configs(report)
    print(f"[joint] (b, c) configs 3 and 4 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the superc sector only: with the nonsu2 one as well (40.7 s) the
    # script took 909.3 s on the card, over its 850 s budget
    t0 = time.perf_counter()
    _big_sector(report, "superc")
    print(f"[joint] (d) superc 2.7M sector in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


MESH_WORLD = 2             # ranks of the mesh phase
# its whole sharded solve: config 2 at nbath 5, cut in depth to one level a
# sector and with the twin sectors rebuilt (every collective of two ranks
# on one card goes through the host: 1.3 ms an all-reduce; the full-depth
# solve took 286.75 s against 32.28 s on one card)
MESH_NBATH = 5
MESH_SOLVE = dict(lanc_nstates_sector=1, ed_twin=True)
MESH_RESTARTS = 4         # (7,7) ground state: Lanczos sweeps of 48 steps
MESH_TIMEOUT = 600        # seconds: the ranks' group timeout and the wait
MESH_SEED = 29            # V3 of the row-range check
MESH_REPS = 10            # timed sharded matvecs (collective: every rank)
MESH_IFNAME = "lo"        # gloo's interface (GLOO_SOCKET_IFNAME) when unset
# (d) config 3 through the sharded blocked Kron, cut in depth as (c): one
# level a sector, the Sz < 0 sectors as twins of the Sz > 0 ones (at the
# joint phase's depth, six levels a sector and no twins, it took 115.55 s
# sharded against 10.88 s on one card with the ranks alone on the card;
# PERF.md, PR 13 call 1)
MESH_KRON = dict(lanc_nstates_sector=1, ed_twin=True)
TOL_KRON = dict(e0=1e-10, dens=1e-8, docc=1e-8, phi=1e-8, gimp=1e-8,
                impf=1e-8)
# (e) the edtpu_site C driver on MESH_WORLD ranks at the n2b4 golden's
# configuration: its sectors above 4·MESH_CAPI_THRESHOLD states with an even
# dw dimension split, the largest ((5,5): 63,504 states) among them, through
# B1's row ranges; below MESH_CAPI_THRESHOLD the sectors go dense
MESH_CAPI_THRESHOLD = 8192


def _mesh_sector77():
    """Config 2's (7,7) sector: its fused operands' host tables."""
    from edipack_tpu_torch.ops.fused_normal import build_fused_normal
    return build_fused_normal(sector_op(2, 6, 7, 7), 2)


def _mesh_v3(mv, dtype):
    """A seeded V3 (the same in every process on the card) in the fused
    operator's layout, whole; its padding is zeroed by ``v0_project``."""
    import torch
    g = torch.Generator(device=mv.device).manual_seed(MESH_SEED)
    return torch.randn(mv.dim, generator=g, dtype=torch.float64,
                       device=mv.device).to(dtype)


def _mesh_solve(device, workdir: str) -> dict:
    """Config 2 at MESH_NBATH through the entry points on ``device`` (on
    every rank of an initialized group, split over them), in ``workdir``
    (no restart file there)."""
    import torch
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    cfg = default_config(norb=2, nbath=MESH_NBATH, nspin=1, ed_verbose=0,
                         **KANAMORI, **MESH_SOLVE)
    ed.ed_init_solver(cfg=cfg, device=device)
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ed.ed_solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(e0=float(res.e0), dens=ed.ed_get_dens().tolist(),
               docc=ed.ed_get_docc().tolist(),
               gimp=ed.ed_get_gimp(_z(cfg.beta)).ravel().tolist(),
               wall_s=wall, timings=res.timings, matvecs=res.n_matvecs,
               launches=read_counts()["B1"],
               largest=max(res.table.get_dim(i)
                           for i in range(len(res.table))))
    out["gimp"] = [[z.real, z.imag] for z in out["gimp"]]
    ed.ed_finalize_solver()
    return out


def _mesh_kron(device, workdir: str) -> dict:
    """(d) BASELINE config 3 (superc, Sz=0 184,756 states) through the
    blocked Kron (ed_joint_kron="always") and the entry points on
    ``device``, in ``workdir``: on the ranks of an initialized group its
    sectors above 4·lanc_dim_threshold split (ShardedJointKronMatvec)."""
    import torch
    import edipack_tpu_torch.main as ed
    from edipack_tpu_torch.config import default_config
    from edipack_tpu_torch.parallel import mesh as pm
    from edipack_tpu_torch.profile_solve import CONFIG3
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    cfg = default_config(**CONFIG3, ed_verbose=0, ed_joint_kron="always",
                         **MESH_KRON)
    ed.ed_init_solver(cfg=cfg, device=device)
    ed.ed_set_hloc(np.zeros((1, 1, 2, 2)))
    torch.cuda.synchronize()
    pm.n_gathers = pm.n_reduces = 0
    t0 = time.perf_counter()
    res = ed.ed_solve()
    torch.cuda.synchronize()
    z = _z(cfg.beta)
    out = dict(e0=float(res.e0), wall_s=time.perf_counter() - t0,
               timings=res.timings, matvecs=res.n_matvecs,
               gathers=pm.n_gathers, reduces=pm.n_reduces,
               largest=max(res.table.get_dim(i)
                           for i in range(len(res.table))))
    for key, arr in (("dens", ed.ed_get_dens()), ("docc", ed.ed_get_docc()),
                     ("phi", ed.ed_get_phi()), ("gimp", ed.ed_get_gimp(z)),
                     ("impf", ed.ed_build_impf(z))):
        arr = np.asarray(arr)
        out[key] = (np.stack([arr.real, arr.imag], -1) if np.iscomplexobj(arr)
                    else arr).tolist()
    ed.ed_finalize_solver()
    return out


def mesh_rank(rank: int, out_dir: str, backend: str) -> int:
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank R DIR
    BACKEND``): (a) B1 and B2 on this rank's rows of the (7,7) sector,
    written to DIR, and the sharded matvec timed; (b) the (7,7) lowest
    level through the sharded B1 operator; (c) config 2 at MESH_NBATH
    through ed_solve; (d) config 3 through the sharded blocked Kron. Its
    numbers go to DIR/rank<R>.json."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    try:
        torch.set_num_threads(LANE_THREADS)
        dev = torch.device(f"cuda:{rank}" if backend == "nccl" else "cuda:0")
        torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(out_dir, 'store')}",
            rank=rank, world_size=MESH_WORLD,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
        from edipack_tpu_torch.ops import fused_matvec as fm
        from edipack_tpu_torch.ops.lanczos import eigsh_lowest
        from edipack_tpu_torch.parallel import mesh as pm
        mesh = pm.make_mesh(dev)
        out = dict(rank=rank, mesh=repr(mesh), device=str(dev))
        print(f"[mesh rank {rank}] {mesh}, GLOO_SOCKET_IFNAME "
              f"{os.environ.get('GLOO_SOCKET_IFNAME')}", flush=True)
        one = torch.ones((), dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        for _ in range(200):
            mesh.allreduce_sum(one)
        out["allreduce_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        fop = _mesh_sector77()
        for tag, dtype in (("b1", torch.float64), ("b2", torch.float32)):
            part = fm.ShardedFusedKron(fop, dev, dtype, mesh)
            v = part.v0_project(part.local(_mesh_v3(part, dtype)))
            w = part(v)
            torch.save(w.cpu(), os.path.join(out_dir, f"{tag}_{rank}.pt"))
            full = part.gather(v).reshape(-1, 128)
            out[tag] = dict(
                rows=list(part.rows), ms=cuda_ms(lambda: part(v),
                                                 reps=MESH_REPS),
                gather_ms=cuda_ms(lambda: part.gather(v), reps=MESH_REPS),
                kernel_ms=cuda_ms(lambda: fm.fused_matvec(full, part.ops,
                                                          part.rows)))
            print(f"[mesh rank {rank}] {tag}: {out[tag]}", flush=True)
            del part, v, w, full
        part = fm.ShardedFusedKron(fop, dev, torch.float64, mesh)
        torch.cuda.synchronize()
        reset_counts()
        pm.n_gathers = 0
        t0 = time.perf_counter()
        stats: dict = {}
        vals, _ = eigsh_lowest(part, part.dim, 1, tol=1e-14, stats=stats,
                               max_restarts=MESH_RESTARTS, mesh=mesh)
        torch.cuda.synchronize()
        out["e77"] = dict(e0=float(vals[0]), s=time.perf_counter() - t0,
                          matvecs=stats["n_matvecs"],
                          launches=read_counts()["B1"],
                          gathers=pm.n_gathers)
        print(f"[mesh rank {rank}] (7,7): {out['e77']}", flush=True)
        del part
        torch.cuda.empty_cache()
        pm.n_gathers = pm.n_reduces = 0
        out["solve"] = _mesh_solve(dev, os.path.join(out_dir, f"solve{rank}"))
        out["solve"].update(gathers=pm.n_gathers, reduces=pm.n_reduces)
        print(f"[mesh rank {rank}] nbath {MESH_NBATH}: wall "
              f"{out['solve']['wall_s']:.2f} s, {out['solve']['timings']}, "
              f"{pm.n_gathers} gathers, {pm.n_reduces} all-reduces",
              flush=True)
        torch.cuda.empty_cache()
        out["kron"] = _mesh_kron(dev, os.path.join(out_dir, f"kron{rank}"))
        print(f"[mesh rank {rank}] config 3 sharded Kron: wall "
              f"{out['kron']['wall_s']:.2f} s, {out['kron']['timings']}, "
              f"{out['kron']['gathers']} gathers, {out['kron']['reduces']} "
              f"all-reduces", flush=True)
        print(f"[mesh rank {rank}] done: (7,7) e0 {out['e77']['e0']:.12f}, "
              f"nbath {MESH_NBATH} e0 {out['solve']['e0']:.12f}, config 3 "
              f"e0 {out['kron']['e0']:.12f}", flush=True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
        return 0
    except Exception:                                   # noqa: BLE001
        traceback.print_exc()
        sys.stdout.flush()
        return 1


def _mesh_ranks(out_dir: str, backend: str) -> list:
    """Start the ranks, wait for them (killing them all at MESH_TIMEOUT),
    print their logs' mesh lines, and return their results; a rank that
    fails fails the phase."""
    procs, logs = [], []
    # the ranks share this host: gloo's pairs connect over the loopback
    # interface, not over the address the host name resolves to
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", MESH_IFNAME)
    for r in range(MESH_WORLD):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), out_dir, backend], stdout=log, stderr=subprocess.STDOUT,
            cwd=out_dir, env=env))
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{r}.log")) as fh:
            text = fh.read()
        for line in text.splitlines():
            if line.startswith("[mesh"):
                print(line)
        if p.returncode != 0:
            print(text[-4000:])
            fail(f"mesh rank {r} exited with {p.returncode}")
    out = []
    for r in range(MESH_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def _mesh_capi_start(out_dir: str, backend: str) -> dict:
    """(e) start the edtpu_site C driver as MESH_WORLD processes of one
    group (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set, as torchrun sets
    them), each in a directory of its own, at the n2b4 golden's
    configuration with files written (:func:`_mesh_capi_check` waits for
    them)."""
    import socket
    from edipack_tpu_torch.capi import build
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    t0 = time.perf_counter()
    lib = build.build()
    exe = os.path.join(out_dir, "edtpu_site")
    out = subprocess.run(
        ["gcc", "-O2", *build.include_flags(), "-o", exe,
         os.path.join(build.CAPI_DIR, "drivers", "edtpu_site.c"),
         *build.link_flags(lib)], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"mesh (e): edtpu_site does not build:\n{out.stderr}")
    config = dict(gold["config"], lmats=gold["nmats"],
                  lanc_dim_threshold=MESH_CAPI_THRESHOLD,
                  ed_fused_matvec="always", ed_write_files=True,
                  ed_verbose=2)
    path_in = os.path.join(out_dir, "capi.in")
    with open(path_in, "w") as fh:
        for k, v in config.items():
            v = ",".join(map(str, v)) if isinstance(v, list) else v
            fh.write(f"{k.upper()}={v}\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(MESH_WORLD),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS=str(LANE_THREADS),
               EDIPACK_TPU_TORCH_GROUP_TIMEOUT=str(MESH_TIMEOUT),
               EDIPACK_TPU_TORCH_DEVICE="cuda" if backend == "nccl"
               else "cuda:0",
               EDIPACK_TPU_TORCH_LAUNCH_LOG=os.path.join(
                   out_dir, "capi_{rank}.json"))
    env.setdefault("GLOO_SOCKET_IFNAME", MESH_IFNAME)
    procs = []
    for r in range(MESH_WORLD):
        cwd = os.path.join(out_dir, f"capi{r}")
        os.makedirs(cwd)
        # output to files: the lane reads them once the ranks are done
        with open(os.path.join(out_dir, f"capi{r}.out"), "w") as so, \
                open(os.path.join(out_dir, f"capi{r}.err"), "w") as se:
            procs.append(subprocess.Popen(
                [exe, path_in, "1", str(config["norb"]),
                 str(config["lmats"])], cwd=cwd, stdout=so, stderr=se,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    return dict(procs=procs, t0=t0, gold=gold, config=config,
                out_dir=out_dir)


def _mesh_capi_check(started: dict) -> dict:
    """(e) wait for the C driver's ranks (killing them MESH_TIMEOUT after
    the check starts) and hold each rank's printed numbers to the golden
    at TOL, rank 0 alone writing files, each rank's launch log with B1
    launches and mesh gathers. Returns its wall, each rank's launch log
    and deviations."""
    procs, gold, out_dir = started["procs"], started["gold"], \
        started["out_dir"]
    norb, lm = started["config"]["norb"], started["config"]["lmats"]
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - started["t0"]
    outs = []
    for r in range(MESH_WORLD):
        with open(os.path.join(out_dir, f"capi{r}.out")) as fo, \
                open(os.path.join(out_dir, f"capi{r}.err")) as fe:
            outs.append((fo.read(), fe.read()))
    result = dict(wall_s=wall, threshold=MESH_CAPI_THRESHOLD, ranks=[])
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "Traceback" in se:
            fail(f"mesh (e): rank {r} rc {p.returncode}\n{so[-2000:]}\n"
                 f"{se[-4000:]}")
        vals = {}
        for line in so.splitlines():
            key, *rest = line.split()
            if key in ("EVALS", "DENS", "DOCC", "MAGZ", "EIMP", "G"):
                vals[key] = np.array([float(x) for x in rest[1:]])
        g = vals["G"][0::2] + 1j * vals["G"][1::2]
        got = dict(e0=vals["EVALS"].min(), evals=np.sort(vals["EVALS"]),
                   dens=vals["DENS"], docc=vals["DOCC"],
                   energies=vals["EIMP"],
                   gimp=g.reshape(1, 1, norb, norb, lm))
        devs = {}
        for k, v in got.items():
            want = _cplx(gold[k]) if k == "gimp" else np.sort(gold[k]) \
                if k == "evals" else np.asarray(gold[k])
            if np.shape(v) != np.shape(want):
                fail(f"mesh (e): rank {r} {k} has shape {np.shape(v)}, the "
                     f"golden {np.shape(want)}")
            devs[k] = float(np.max(np.abs(v - want)))
        with open(os.path.join(out_dir, f"capi_{r}.json")) as fh:
            log = json.load(fh)
        files = sorted(os.listdir(os.path.join(out_dir, f"capi{r}")))
        mesh_line = [ln for ln in so.splitlines() if "Mesh(" in ln][:1]
        print(f"[mesh] (e) rank {r} edtpu_site (lanc_dim_threshold "
              f"{MESH_CAPI_THRESHOLD}): {mesh_line}, launch log {log}, "
              f"{len(files)} files written; deviations from the golden "
              + ", ".join(f"{k} {v:.3e}" for k, v in devs.items()))
        for k, v in devs.items():
            if not v <= TOL["e0" if k == "evals" else k]:
                fail(f"mesh (e): rank {r} {k} off the golden by {v:.3e}")
        if log["B1"] <= 0 or log["gathers"] <= 0 or not mesh_line:
            fail(f"mesh (e): rank {r} launched no B1, gathered nothing or "
                 f"printed no mesh: {log}")
        if (r == 0) != bool(files):
            fail(f"mesh (e): rank {r} wrote {files}")
        result["ranks"].append(dict(log=log, devs=devs, files=len(files)))
    print(f"[mesh] (e) the C driver on {MESH_WORLD} ranks, beside the "
          f"ranks of (a)-(d): {wall:.1f} s (the library and the driver "
          f"built in it)", flush=True)
    return result


def phase_mesh(report: dict) -> None:
    """Two ranks of torch.distributed on the card (gloo, host-staged, when
    there is one card; NCCL, one card a rank, when there are two): B1/B2
    row ranges at (7,7) bitwise against the single-card kernels, the
    sharded (7,7) ground state against the single-card one, and a whole
    sharded config 2 solve at MESH_NBATH against the unsharded one. The
    single-card references run first, in this process."""
    import shutil
    import tempfile
    import torch
    from edipack_tpu_torch.ops import fused_matvec as fm
    from edipack_tpu_torch.ops.lanczos import eigsh_lowest
    dev = torch.device(DEVICE)
    backend = "nccl" if torch.cuda.device_count() >= MESH_WORLD else "gloo"
    print(f"[mesh] backend {backend}, world size {MESH_WORLD}, card "
          f"{card_line()}", flush=True)
    fop = _mesh_sector77()
    ref = {}
    for tag, dtype in (("b1", torch.float64), ("b2", torch.float32)):
        whole = fm.FusedKron(fop, dev, dtype)
        v = whole.v0_project(_mesh_v3(whole, dtype))
        ref[tag] = whole(v).cpu().view(whole.nbu, whole.ddp, 128)
        v3 = v.reshape(-1, 128)
        ref[tag + "_ms"] = cuda_ms(lambda: fm.fused_matvec(v3, whole.ops))
        del whole, v, v3
    whole = fm.FusedKron(fop, dev, torch.float64)
    t0 = time.perf_counter()
    vals, _ = eigsh_lowest(whole, whole.dim, 1, tol=1e-14,
                           max_restarts=MESH_RESTARTS)
    torch.cuda.synchronize()
    e77, t77 = float(vals[0]), time.perf_counter() - t0
    del whole, vals
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(ROOT,
                                                                 "build"))
    cwd = os.getcwd()
    try:
        try:
            plain = _mesh_solve(DEVICE, os.path.join(out_dir, "single"))
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
        try:
            kron = _mesh_kron(DEVICE, os.path.join(out_dir, "kron_single"))
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
        print(f"[mesh] single card: config 3 blocked Kron e0 "
              f"{kron['e0']:.12f} in {kron['wall_s']:.2f} s "
              f"({kron['matvecs']} matvecs)", flush=True)
        print(f"[mesh] single card: (7,7) e0 {e77:.12f} in {t77:.2f} s; B1 "
              f"{ref['b1_ms']:.4f} ms, B2 {ref['b2_ms']:.4f} ms back to "
              f"back; nbath {MESH_NBATH} solve e0 {plain['e0']:.12f} in "
              f"{plain['wall_s']:.2f} s ({plain['matvecs']} matvecs, B1 "
              f"{plain['launches']})", flush=True)
        t0 = time.perf_counter()
        capi = _mesh_capi_start(out_dir, backend)
        try:
            ranks = _mesh_ranks(out_dir, backend)
        except BaseException:
            for p in capi["procs"]:
                p.kill()
                p.wait()
            raise
        wall_ranks = time.perf_counter() - t0
        capi = _mesh_capi_check(capi)
        for rk in ranks:
            r = rk["rank"]
            for tag in ("b1", "b2"):
                row0, nrows = rk[tag]["rows"]
                got = torch.load(os.path.join(out_dir, f"{tag}_{r}.pt"))
                want = ref[tag][:, row0:row0 + nrows].reshape(-1)
                same = torch.equal(got, want)
                print(f"[mesh] (a) rank {r} {tag.upper()} rows {row0}:"
                      f"{row0 + nrows}: bitwise equal to the single card "
                      f"{same}; sharded matvec (gather + kernel) "
                      f"{rk[tag]['ms']:.4f} ms, the row-range kernel "
                      f"{rk[tag]['kernel_ms']:.4f} ms, single card "
                      f"{ref[tag + '_ms']:.4f} ms (back to back)")
                if not same:
                    fail(f"mesh rank {r}: {tag} rows differ from the single "
                         f"card's")
            e = rk["e77"]
            dev_e = abs(e["e0"] - e77)
            print(f"[mesh] (b) rank {r} (7,7) e0 {e['e0']:.12f}, |diff| "
                  f"{dev_e:.3e} (limit 1e-10; {MESH_RESTARTS} sweeps, "
                  f"converged level of the solve phase "
                  f"{report.get('e77', float('nan')):.12f}); "
                  f"{e['matvecs']} matvecs, {e['launches']} B1 launches, "
                  f"{e['s']:.2f} s; all-reduce {rk['allreduce_ms']:.3f} ms")
            if not (dev_e <= 1e-10 and e["launches"] > 0):
                fail(f"mesh rank {r}: sharded (7,7) e0 off by {dev_e:.3e} "
                     f"or no B1 launch ({e['launches']})")
            sv = rk["solve"]
            devs = {k: float(np.max(np.abs(np.asarray(sv[k])
                                           - np.asarray(plain[k]))))
                    for k in ("e0", "dens", "docc", "gimp")}
            print(f"[mesh] (c) rank {r} nbath {MESH_NBATH} (largest sector "
                  f"{sv['largest']}): e0 {sv['e0']:.12f}, wall "
                  f"{sv['wall_s']:.2f} s (single card {plain['wall_s']:.2f}"
                  f" s), B1 launches {sv['launches']}, {sv['gathers']} "
                  f"gathers, {sv['reduces']} all-reduces; deviations "
                  + ", ".join(f"{k} {v:.3e}" for k, v in devs.items()))
            for k, v in devs.items():
                if not v <= TOL[k]:
                    fail(f"mesh rank {r}: sharded solve {k} off by {v:.3e}")
            if sv["launches"] <= 0:
                fail(f"mesh rank {r}: the sharded solve launched no B1")
            kv = rk["kron"]
            devs = {k: float(np.max(np.abs(np.asarray(kv[k])
                                           - np.asarray(kron[k]))))
                    for k in TOL_KRON}
            print(f"[mesh] (d) rank {r} config 3 sharded Kron (largest "
                  f"sector {kv['largest']}): e0 {kv['e0']:.12f}, wall "
                  f"{kv['wall_s']:.2f} s (single card {kron['wall_s']:.2f} "
                  f"s), {kv['matvecs']} matvecs, {kv['gathers']} gathers, "
                  f"{kv['reduces']} all-reduces; phases {kv['timings']}; "
                  f"deviations "
                  + ", ".join(f"{k} {v:.3e}" for k, v in devs.items()))
            for k, v in devs.items():
                if not v <= TOL_KRON[k]:
                    fail(f"mesh rank {r}: config 3 sharded Kron {k} off by "
                         f"{v:.3e}")
            if kv["gathers"] <= 0:
                fail(f"mesh rank {r}: config 3 made no sharded Kron gather")
        print(f"[mesh] ranks done in {wall_ranks:.1f} s")
        report["mesh"] = dict(backend=backend, world=MESH_WORLD,
                              wall_ranks_s=wall_ranks, single=plain,
                              e77=e77, ranks=ranks, kron_single=kron,
                              capi=capi, b1_ms=ref["b1_ms"],
                              b2_ms=ref["b2_ms"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


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
             launches_ineq_golden=report["B1_launches_ineq_golden"],
             launches_ineq=report["B1_launches_ineq"],
             launches_capi=report["B1_launches_capi"],
             launches_mesh_solve=[r["solve"]["launches"]
                                  for r in report["mesh"]["ranks"]],
             launches_mesh_capi=[r["log"]["B1"] for r in
                                 report["mesh"]["capi"]["ranks"]],
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


MAIN = (("build", phase_build), ("kernel", phase_kernel),
        ("golden", phase_golden), ("solve", phase_solve),
        ("trace", phase_trace), ("extras", phase_extras),
        ("ineq", phase_ineq), ("capi", phase_capi))
LANE = (("mesh", phase_mesh), ("joint", phase_joint), ("dmft", phase_dmft))
LANE_AFTER = "solve"      # the lane starts once this main phase is done
LANE_WAIT = 600           # seconds the main process waits for it at the end
LANE_THREADS = 2          # torch CPU threads of the lane and the mesh ranks


def _setup() -> None:
    import torch
    sys.path.insert(0, ROOT)
    import edipack_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_phases(report: dict, phases) -> None:
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(report)
        print(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s",
              flush=True)


def lane(out_json: str, e77: str) -> int:
    """The LANE phases in this process (``chip_smoke.py --lane OUT E77``;
    E77: the solve phase's (7,7) level, printed beside the mesh phase's):
    their report, as JSON, to OUT."""
    import torch
    _setup()
    torch.set_num_threads(LANE_THREADS)
    report: dict = {"e77": float(e77)}
    t0 = time.perf_counter()
    run_phases(report, LANE)
    print(f"[lane] {', '.join(n for n, _ in LANE)} done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(out_json, "w") as fh:
        json.dump(report, fh, default=str)
    return 0


def _start_lane(report: dict) -> dict:
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="lane_", dir=os.path.join(ROOT, "build"))
    with open(os.path.join(out, "lane.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane",
             os.path.join(out, "report.json"), repr(report["e77"])],
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    print(f"[lane] {', '.join(n for n, _ in LANE)} started beside the main "
          f"phases (pid {proc.pid})", flush=True)
    return dict(proc=proc, dir=out, t0=time.perf_counter())


def _stop_lane(ln: dict) -> None:
    """Kill the lane's process group (the lane and its mesh ranks)."""
    import signal
    if ln["proc"].poll() is None:
        try:
            os.killpg(ln["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        ln["proc"].wait()


def _join_lane(ln: dict, report: dict) -> None:
    """Wait for the lane (at most LANE_WAIT s), print its log and merge its
    report; a lane that failed or did not end fails the run."""
    import shutil
    t_wait = time.perf_counter()
    try:
        rc = ln["proc"].wait(timeout=LANE_WAIT)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        _stop_lane(ln)
    with open(os.path.join(ln["dir"], "lane.log")) as fh:
        text = fh.read()
    print(text, end="", flush=True)
    if rc != 0:                 # the lane's fault on stderr too
        print(text[-6000:], file=sys.stderr, flush=True)
    print(f"[lane] exit {rc}, joined {time.perf_counter() - ln['t0']:.1f} s "
          f"after it started; the main process waited "
          f"{time.perf_counter() - t_wait:.1f} s for it", flush=True)
    if rc != 0:
        fail(f"the lane ({', '.join(n for n, _ in LANE)}) "
             f"{'did not end' if rc is None else f'exited with {rc}'}")
    with open(os.path.join(ln["dir"], "report.json")) as fh:
        report.update(json.load(fh))
    shutil.rmtree(ln["dir"], ignore_errors=True)


def main() -> int:
    import torch
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-rank":
        return mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--lane":
        return lane(sys.argv[2], sys.argv[3])
    _setup()
    print(card_line())          # name, power limit, as nvidia-smi gives them
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report: dict = {}
    t_all = time.perf_counter()
    ln = None
    try:
        for phase in MAIN:
            run_phases(report, (phase,))
            if phase[0] == LANE_AFTER:
                ln = _start_lane(report)
        _join_lane(ln, report)
    finally:
        if ln is not None:
            _stop_lane(ln)
    print(f"[done] all phases in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernel_report(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
