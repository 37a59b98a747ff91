"""Build the C example ``hm_bethe.c`` against libedipack_tpu_torch_c.so.

    python -m edipack_tpu_torch.examples.c.build   # prints the program

The C library is built first if needed (capi/build.py); the example is
compiled by ``gcc`` with that module's :func:`include_flags` and
:func:`link_flags` into ``build/edipack_tpu_torch/examples/hm_bethe`` at
the repository root, written under a temporary name and moved into place.
A failed compile raises with gcc's output.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

from ...capi import build as capi_build

SOURCE = Path(__file__).resolve().parent / "hm_bethe.c"
BUILD_DIR = capi_build.BUILD_DIR.parent / "examples"


def build() -> Path:
    """The example program, compiled from ``hm_bethe.c``; returns its
    path."""
    lib = capi_build.build()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "hm_bethe"
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [capi_build._gcc(), "-O2", "-Wall",
           *capi_build.include_flags(), "-o", str(tmp), str(SOURCE),
           *capi_build.link_flags(lib), "-lm"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"edipack_tpu_torch: hm_bethe.c does not build "
                           f"({' '.join(cmd)}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
