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
import time
from typing import Dict, Union

import torch

DTYPE = torch.float64
PRECISIONS = {"float64": torch.float64, "float32": torch.float32}


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
    charged the device work it enqueued and not just its launch time."""

    def __init__(self, device: torch.device, verbose: int = 0):
        self.device = device
        self.timings: Dict[str, float] = {}
        self.verbose = verbose

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
