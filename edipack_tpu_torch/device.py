"""Device and dtype policy, and per-phase wall-clock timing.

Every tensor of the solve lives on one explicit ``torch.device`` chosen by
the caller (``EDSolver(cfg, device=...)``); the default is ``"cuda"`` and
there is no silent fallback to the CPU. Arithmetic is f64 by default: the
card has native FP64, so none of the double-single workarounds of the TPU
package are needed. ``ed_precision="float32"`` runs the Lanczos sectors in
f32, as the TPU package does (:func:`working_dtype`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch

DTYPE = torch.float64
PRECISIONS = {"float64": torch.float64, "float32": torch.float32}
PROFILE_ENV = "EDIPACK_TPU_TORCH_PROFILE_DIR"


def working_dtype(cfg) -> torch.dtype:
    """dtype of the Lanczos sectors' matvecs and vectors for
    ``cfg.ed_precision`` (cf. edipack_tpu.solver.core._normal_builders).
    Dense buckets and exact GF moments stay f64 at either precision."""
    return PRECISIONS[cfg.ed_precision]


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The solve's device; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "edipack_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Wall-clock time per named phase (reference SF_TIMER around each
    phase). On CUDA each phase edge synchronizes the device, so a phase is
    charged the device work it enqueued and not just its launch time.

    ``trace_dir`` (else ``EDIPACK_TPU_TORCH_PROFILE_DIR``; edipack_tpu's
    ``ed_profile_dir`` / ``EDIPACK_TPU_PROFILE_DIR``): entering the timer
    as a context manager starts a ``torch.profiler`` trace (CPU activity,
    and CUDA activity on a CUDA device), and leaving it writes the Chrome
    trace ``solve_<time>_<pid>_<n>.pt.trace.json`` into that directory,
    which is made if missing. Without a directory there is no profiler."""

    _traces = 0          # traces written by this process (file names)

    def __init__(self, device: torch.device, verbose: int = 0,
                 trace_dir: Optional[str] = None):
        self.device = device
        self.timings: Dict[str, float] = {}
        self.verbose = verbose
        self.trace_dir = trace_dir or os.environ.get(PROFILE_ENV) or None
        self._prof = None

    def __enter__(self) -> "PhaseTimer":
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is not None:
            synchronize(self.device)
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            PhaseTimer._traces += 1
            self._prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"solve_{time.strftime('%Y%m%d_%H%M%S')}_"
                f"{os.getpid()}_{PhaseTimer._traces}.pt.trace.json"))
            self._prof = None
        return False

    @contextlib.contextmanager
    def phase(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            if self.verbose >= 2:
                print(f"[edipack_tpu_torch] {name}: {dt:.3f}s")
