"""Build the C library of edipack_tpu_torch at first use.

    python -m edipack_tpu_torch.capi.build      # builds if needed, prints
                                                # the library's path

``edipack_tpu_capi.c`` (the ``edtpu_*`` API, ``edipack_tpu.h``) and
``edipack_compat.c`` (the reference EDIpack C-binding names,
``edipack_compat.h``) are compiled by ``gcc`` into one shared library,
``libedipack_tpu_torch_c.so``, that embeds the interpreter. The compile
and link flags come from the ``sysconfig`` of the interpreter that runs
the build (``python3-config --embed`` semantics), and the library starts
its embedded interpreter as that same program, so it finds the same
installed packages. The library lands in
``build/edipack_tpu_torch/capi/<hash>/`` at the repository root, the
directory named by a hash of the sources, headers and flags, so an edited
source rebuilds; it is written under a temporary name and moved into
place, so concurrent builds do not collide. A missing ``gcc`` or
``Python.h``, or a failed build, raises with gcc's output.

A C driver compiles with :func:`include_flags` and links with
:func:`link_flags` (``-L<dir> -ledipack_tpu_torch_c -Wl,-rpath,<dir>``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import List, Optional

CAPI_DIR = Path(__file__).resolve().parent
SOURCES = (CAPI_DIR / "edipack_tpu_capi.c", CAPI_DIR / "edipack_compat.c")
HEADERS = (CAPI_DIR / "edipack_tpu.h", CAPI_DIR / "edipack_compat.h",
           CAPI_DIR / "compat_include" / "edipack_cbindings.h",
           CAPI_DIR / "compat_include" / "mpi.h")
BUILD_DIR = CAPI_DIR.parents[1] / "build" / "edipack_tpu_torch" / "capi"
LIB_NAME = "edipack_tpu_torch_c"

build_seconds = 0.0     # gcc's time of the build done by this process


def python_include() -> Path:
    return Path(sysconfig.get_paths()["include"])


def python_flags() -> tuple:
    """(compile flags, link flags) for embedding this interpreter."""
    var = sysconfig.get_config_var
    cflags = [f"-I{python_include()}"]
    plat = sysconfig.get_paths().get("platinclude")
    if plat and Path(plat) != python_include():
        cflags.append(f"-I{plat}")
    libdir = var("LIBDIR")
    ldflags = [f"-L{libdir}"]
    if not var("Py_ENABLE_SHARED"):
        ldflags.append(f"-L{var('LIBPL')}")
    ldflags += [f"-lpython{var('VERSION')}{var('ABIFLAGS') or ''}",
                *(var("LIBS") or "").split(), *(var("SYSLIBS") or "").split(),
                f"-Wl,-rpath,{libdir}"]
    # the embedded interpreter starts as this program (capi's EDTPU_PYTHON)
    cflags.append(f"-DEDTPU_PYTHON={json.dumps(sys.executable)}")
    return cflags, ldflags


def _gcc() -> str:
    cc = shutil.which("gcc")
    if not cc:
        raise RuntimeError("edipack_tpu_torch: gcc not found; the C library "
                           "cannot be built")
    return cc


def _command(out: Path) -> List[str]:
    cflags, ldflags = python_flags()
    return [_gcc(), "-O2", "-fPIC", "-shared", "-Wall",
            f"-I{CAPI_DIR}", *cflags, "-o", str(out),
            *map(str, SOURCES), *ldflags]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_command(Path("lib"))).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{LIB_NAME}.so"


def build() -> Path:
    """The library, built from the sources if needed; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    if not (python_include() / "Python.h").exists():
        raise RuntimeError(f"edipack_tpu_torch: no Python.h under "
                           f"{python_include()}; the C library cannot be "
                           f"built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = _command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"edipack_tpu_torch: C library build failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def include_flags() -> List[str]:
    """gcc flags that find edipack_tpu.h, edipack_compat.h and the
    reference's edipack_cbindings.h / mpi.h names."""
    return [f"-I{CAPI_DIR}", f"-I{CAPI_DIR / 'compat_include'}"]


def link_flags(lib: Optional[Path] = None) -> List[str]:
    lib = lib or build()
    return [f"-L{lib.parent}", f"-l{LIB_NAME}", f"-Wl,-rpath,{lib.parent}"]


if __name__ == "__main__":
    print(build())
