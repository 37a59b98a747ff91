"""Flat-buffer helpers of the C library (edipack_tpu_torch/capi), and the
library's device.

The C layer passes flat float lists and dimensions; these helpers reshape
them and call the public ed_* API; counterpart of edipack_tpu.capihelp.
Parity targets are the reference C bindings
(src/c_bindings/edipack_cbindings.h): init_Hreplica/Hgeneral_symmetries_*,
the get_sigma/gimp rank overloads, the lattice (ineq) variants, the χ
getters.

The device of every solver the library makes comes from the environment
variable ``EDIPACK_TPU_TORCH_DEVICE``: ``cuda`` (the default), ``cuda:N``
or ``cpu``. The value is checked against that list when this module is
imported (``edtpu_init`` imports it first), and ``cuda`` without CUDA
fails there too: a bad value makes the import, and so ``edtpu_init``,
fail with this module's message, and nothing runs on another device.

A process group (:func:`join_group`, also at the import): with
``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment (what ``torchrun --no-python --nproc-per-node N ./driver``
sets), the library joins the default group of torch.distributed, and the
solves split their large sectors over its ranks as a Python SPMD program's
do (parallel.mesh): NCCL with the card ``cuda:LOCAL_RANK`` when the device
is ``cuda`` and there are as many cards as ranks, else gloo on the device
named (ranks sharing one card, or the CPU), over the loopback interface
unless ``GLOO_SOCKET_IFNAME`` is set. ``EDIPACK_TPU_TORCH_GROUP_TIMEOUT``
(seconds, default 600) bounds the rendezvous and every collective. A group
that does not form fails the import, and so ``edtpu_init``; rank 0 alone
writes files; :func:`finalize_library` destroys the group the library
made.
"""
from __future__ import annotations

import datetime
import json
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import main as M
from .config import get_config
from .device import resolve_device
from .ineq import EDIneqSolver

DEVICE_ENV = "EDIPACK_TPU_TORCH_DEVICE"
_DEVICE_RE = re.compile(r"cuda|cuda:[0-9]+|cpu")
LAUNCH_LOG_ENV = "EDIPACK_TPU_TORCH_LAUNCH_LOG"
GROUP_TIMEOUT_ENV = "EDIPACK_TPU_TORCH_GROUP_TIMEOUT"
GROUP_ENV = ("RANK", "MASTER_ADDR", "MASTER_PORT")


def library_device() -> torch.device:
    """The device named by EDIPACK_TPU_TORCH_DEVICE (default ``cuda``);
    raises for a value outside the list, or for CUDA where it is absent."""
    raw = os.environ.get(DEVICE_ENV, "cuda")
    if not _DEVICE_RE.fullmatch(raw):
        raise ValueError(f"{DEVICE_ENV}={raw!r} is not one of: cuda, "
                         f"cuda:N, cpu")
    return resolve_device(raw)


def join_group(device: torch.device) -> Tuple[torch.device, bool]:
    """Join the default process group the environment names (see the
    module docstring); returns the rank's device and whether a group was
    made. Without ``WORLD_SIZE`` > 1, or inside a group already, nothing
    changes."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or dist.is_initialized():
        return device, False
    missing = [k for k in GROUP_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"edipack_tpu_torch: WORLD_SIZE={world} needs "
                           f"{', '.join(missing)} in the environment")
    rank = int(os.environ["RANK"])
    if os.environ.get(DEVICE_ENV, "cuda") == "cuda" \
            and torch.cuda.device_count() >= world:
        backend = "nccl"
        device = torch.device(f"cuda:{os.environ.get('LOCAL_RANK', rank)}")
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = float(os.environ.get(GROUP_TIMEOUT_ENV, "600"))
    try:
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
    except Exception as exc:
        raise RuntimeError(
            f"edipack_tpu_torch: rank {rank} of {world} could not join the "
            f"{backend} group at {os.environ['MASTER_ADDR']}:"
            f"{os.environ['MASTER_PORT']} within {timeout:g} s: "
            f"{type(exc).__name__}: {exc}") from exc
    return device, True


DEVICE, OWN_GROUP = join_group(library_device())

_ineq: Optional[EDIneqSolver] = None


def finalize_library() -> None:
    """What ``edtpu_finalize`` and the reference ABI's
    ``finalize_solver`` do after the solver: write the launch log, and
    destroy the process group the library made (and only that one)."""
    global OWN_GROUP
    write_launch_log()
    if OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    OWN_GROUP = False


def write_launch_log() -> None:
    """With EDIPACK_TPU_TORCH_LAUNCH_LOG set, write this process's CUDA
    kernel launches so far (the wrappers' counters: B1, B2, B3, B4) and
    its mesh collectives (parallel.mesh's gathers and all-reduces) there
    as JSON. ``edtpu_finalize`` and the reference ABI's
    ``finalize_solver`` call it, so that a C driver's launches can be read
    from outside its process (chip_smoke.py's capi phase). ``{rank}`` in
    the path stands for the process's rank in its group (0 alone)."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if not path:
        return
    path = path.replace("{rank}", str(dist.get_rank()
                                      if dist.is_initialized() else 0))
    from .ops import fused_matvec as fm
    from .ops import kron_tiles as kt
    from .parallel import mesh as pm
    with open(path, "w") as fh:
        json.dump(dict(B1=fm.launches, B2=fm.launches_f32,
                       B3=fm.power_launches, B4=kt.launches,
                       gathers=pm.n_gathers, reduces=pm.n_reduces), fh)


def _cplx(re_, im, shape):
    a = np.asarray(re_, float).reshape(shape)
    b = np.asarray(im, float).reshape(shape) if im is not None else 0.0
    return a + 1j * b


def complex_from_pairs(flat):
    """Interleaved (re, im) doubles -> a complex array."""
    return np.asarray(flat, float).view(complex)


def init_solver():
    """ed_init_solver on the library's device; the packed bath."""
    return np.ascontiguousarray(M.ed_init_solver(device=DEVICE))


# -- replica/general bases --------------------------------------------------

def _lambdas(lam, nsym, nbath):
    lam = np.asarray(lam, float)
    return lam.reshape(nsym) if lam.size == nsym else lam.reshape(nbath, nsym)


def set_hreplica_flat(re_, im, nsym, nspin, norb, lam, nbath):
    from .bath.user import ed_set_hreplica
    ops = _cplx(re_, im, (nsym, nspin, nspin, norb, norb))
    ed_set_hreplica(ops, _lambdas(lam, nsym, nbath), nbath=nbath)
    return 0


def set_hgeneral_flat(re_, im, nsym, nspin, norb, lam, nbath):
    from .bath.user import ed_set_hgeneral
    ops = _cplx(re_, im, (nsym, nspin, nspin, norb, norb))
    ed_set_hgeneral(ops, _lambdas(lam, nsym, nbath), nbath=nbath)
    return 0


# -- dynamical getters on default grids --------------------------------------

def get_gf(which: str, axis: str = "m", typ: str = "n"):
    fn = {"sigma": M.ed_get_sigma, "gimp": M.ed_get_gimp,
          "g0imp": M.ed_get_g0imp, "dimp": M.ed_get_dimp}[which]
    if which == "dimp":
        return np.ascontiguousarray(fn(None, axis))
    return np.ascontiguousarray(fn(None, axis, typ))


def get_chi(kind: str, axis: str = "m"):
    return np.ascontiguousarray(M.ed_get_chi(kind, None, axis))


def get_rdm_flat():
    return np.ascontiguousarray(np.asarray(M.ed_get_rdm()))


def get_sp_dm_flat():
    return np.ascontiguousarray(np.asarray(M.ed_get_sp_dm()))


# -- ineq (lattice) -----------------------------------------------------------

def ineq_init(nineq: int):
    global _ineq
    _ineq = EDIneqSolver(int(nineq), get_config(), device=DEVICE)
    return 0


def _I() -> EDIneqSolver:
    if _ineq is None:
        raise RuntimeError("call ineq_init first")
    return _ineq


def ineq_init_solver(baths_flat=None, nb: int = 0):
    s = _I()
    baths = None
    if baths_flat is not None and nb > 0:
        baths = np.asarray(baths_flat, float).reshape(s.nineq, nb)
    return np.ascontiguousarray(s.init_solver(baths))


def ineq_set_hloc(re_, im, nso: int, per_site: int):
    s = _I()
    shape = (s.nineq, nso, nso) if per_site else (nso, nso)
    s.set_hloc(_cplx(re_, im, shape))
    return 0


def ineq_solve(baths_flat, nb: int, flag_gf: int = 1):
    s = _I()
    baths = np.asarray(baths_flat, float).reshape(s.nineq, nb)
    s.solve(baths, flag_gf=bool(flag_gf))
    return 0


def ineq_get(name: str, *args):
    fn = getattr(_I(), "get_" + name)
    return np.ascontiguousarray(np.asarray(fn(*args)))


def ineq_fit_gf(funcs_flat, l: int, baths_flat, nb: int, ispin: int = 1):
    s = _I()
    cfg = s.solvers[0].cfg
    funcs = np.asarray(funcs_flat, float).view(complex).reshape(
        s.nineq, cfg.norb, cfg.norb, l)
    baths = np.asarray(baths_flat, float).reshape(s.nineq, nb)
    return np.ascontiguousarray(s.fit_gf(funcs, baths, ispin=ispin))
