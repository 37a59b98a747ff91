"""Build and load the package's CUDA kernels at first use.

The sources under ``edipack_tpu_torch/csrc`` are compiled by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface (loaded with ``ctypes``). The library
lands in ``build/edipack_tpu_torch/`` at the repository root and is named
by a hash of the sources and flags, so an edited source rebuilds. A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "row_gather.cu",)
BUILD_DIR = _PKG.parent / "build" / "edipack_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output of the build done by this process
build_seconds = 0.0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("edipack_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libedipack_tpu_torch_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # the fused operands, in FusedOperands.args()'s order
    ops = [p] * 2 + [i] + [p] * 2 + [i] + [p] * 2 + [i] + [p] * 2 + [i] * 3
    for name in ("fused_normal_matvec_f64", "fused_normal_matvec_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 2 + ops + [i] * 2 + [p]      # + row0, nrows
        fn.restype = i
    fn = lib.fused_normal_power_f32
    fn.argtypes = [p] * 3 + ops + [p] * 3 + [i, p]
    fn.restype = i
    fn = lib.kron_tiles_matvec_f32
    fn.argtypes = [p] * 4 + [i] + [p] * 2 + [i, p] + [i] * 2 + [p]
    fn.restype = i
    lib.fused_normal_error_string.argtypes = [i]
    lib.fused_normal_error_string.restype = ctypes.c_char_p


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise with every log if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    for c, p in zip(cmds, procs):
        if p.returncode != 0:
            raise RuntimeError(f"edipack_tpu_torch: kernel build failed "
                               f"({' '.join(c)}):\n{log}")
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources if needed."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        build_log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                              for s, o in zip(SOURCES, objs)])
        build_log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                                *map(str, objs)]])
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, out)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fused_normal_error_string(err).decode()
        raise RuntimeError(f"edipack_tpu_torch: {what} failed: CUDA error "
                           f"{err} ({msg})")
