"""The host library of edipack_tpu_torch: ``edipack_native.cpp`` (the
port's copy of edipack_tpu's native library) bound with ctypes, and its
wrappers (counterpart of edipack_tpu.native).

Its five functions: ``edn_binom``, ``edn_enum_states`` (all ns-bit states
of popcount n, ascending, by Gosper's hack), ``edn_apply_opstring`` (a
c / c† string over a whole state array), ``edn_state_index`` (binary
search in a sorted basis) and ``edn_hop_elements`` (c†_i c_j on a fixed-N
basis). ``fock.enumerate_states`` enumerates sector bases through
:func:`enum_states`, as edipack_tpu's fock does.

The library is built with ``g++ -O3 -shared -fPIC`` at first use into
``build/edipack_tpu_torch/native/<hash>/`` at the repository root, the
directory named by a hash of the source and the command, written under a
temporary name and moved into place, so that concurrent builds do not
collide. A missing g++, a failed build or a failed load raises with the
compiler's or the loader's message: there is no silent fallback.
``EDIPACK_TPU_TORCH_NO_NATIVE=1`` selects the NumPy path of ``fock.py``
explicitly; :func:`available` says which path runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "edipack_native.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "edipack_tpu_torch" / "native"
NO_NATIVE_ENV = "EDIPACK_TPU_TORCH_NO_NATIVE"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def _command(out: Path) -> List[str]:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("edipack_tpu_torch: g++ not found; the native "
                           f"host library cannot be built (set "
                           f"{NO_NATIVE_ENV}=1 for the NumPy path)")
    return [cxx, *FLAGS, "-o", str(out), str(SOURCE)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libedipack_native.so"


def build() -> Path:
    """The library, built from SOURCE if needed; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = _command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"edipack_tpu_torch: native library build failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    ip = ctypes.POINTER(ctypes.c_int)
    i, i64 = ctypes.c_int, ctypes.c_int64
    lib.edn_binom.restype = i64
    lib.edn_binom.argtypes = [i, i]
    lib.edn_enum_states.restype = None
    lib.edn_enum_states.argtypes = [i, i, i64p]
    lib.edn_apply_opstring.restype = None
    lib.edn_apply_opstring.argtypes = [i64p, i64, ip, ip, i, i64p, f64p, u8p]
    lib.edn_state_index.restype = None
    lib.edn_state_index.argtypes = [i64p, i64, i64p, i64, i64p]
    lib.edn_hop_elements.restype = i64
    lib.edn_hop_elements.argtypes = [i64p, i64, i, i, i64p, i64p, f64p]


def disabled() -> bool:
    """True when EDIPACK_TPU_TORCH_NO_NATIVE selects the NumPy path."""
    return os.environ.get(NO_NATIVE_ENV, "") not in ("", "0")


def load() -> ctypes.CDLL:
    """The loaded library (built if needed); raises when it is disabled
    or cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if disabled():
        raise RuntimeError(f"edipack_tpu_torch: the native host library is "
                           f"disabled ({NO_NATIVE_ENV} is set)")
    lib = ctypes.CDLL(str(build()))
    _declare(lib)
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native path runs: False under EDIPACK_TPU_TORCH_NO_NATIVE,
    else True once the library is loaded (a failure raises)."""
    if disabled():
        return False
    load()
    return True


# ---------------------------------------------------------------------------
# wrappers (edipack_tpu.native's, and the index search)
# ---------------------------------------------------------------------------


def enum_states(ns: int, n: int) -> np.ndarray:
    """All ``ns``-bit states with popcount ``n``, ascending (int64)."""
    lib = load()
    out = np.empty(int(lib.edn_binom(ns, n)), dtype=np.int64)
    if out.size:
        lib.edn_enum_states(ns, n, out)
    return out


def hop_elements(basis: np.ndarray, i: int, j: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, signs) of c†_i c_j on the sorted fixed-N ``basis``."""
    lib = load()
    basis = np.ascontiguousarray(basis, np.int64)
    n = len(basis)
    rows = np.empty(n, np.int64)
    cols = np.empty(n, np.int64)
    signs = np.empty(n, np.float64)
    cnt = lib.edn_hop_elements(basis, n, i, j, rows, cols, signs)
    return rows[:cnt], cols[:cnt], signs[:cnt]


def apply_opstring(states: np.ndarray, ops: Sequence[Tuple[str, int]]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(new states, signs, valid) of the string ``ops`` ((kind, level),
    kind 'c' or 'cdg', applied in order) on every state."""
    lib = load()
    states = np.ascontiguousarray(states, np.int64)
    n = len(states)
    kinds = (ctypes.c_int * len(ops))(*[0 if k == "c" else 1 for k, _ in ops])
    levels = (ctypes.c_int * len(ops))(*[lvl for _, lvl in ops])
    out = np.empty(n, np.int64)
    signs = np.empty(n, np.float64)
    valid = np.empty(n, np.uint8)
    lib.edn_apply_opstring(states, n, kinds, levels, len(ops), out, signs,
                           valid)
    return out, signs, valid.astype(bool)


def state_index(basis: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Indices of ``states`` in the sorted ``basis``; -1 where absent."""
    lib = load()
    basis = np.ascontiguousarray(basis, np.int64)
    states = np.ascontiguousarray(states, np.int64)
    out = np.empty(len(states), np.int64)
    lib.edn_state_index(basis, len(basis), states, len(states), out)
    return out
