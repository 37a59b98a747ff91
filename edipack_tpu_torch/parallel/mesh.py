"""Multi-GPU sectors on ``torch.distributed`` (counterpart of
edipack_tpu.parallel.mesh).

SPMD, one process per card, as the reference EDIpack runs one MPI rank per
process: every rank runs the same solve, and a large sector's vector is
split into contiguous row blocks, one a rank.

* normal sectors: the dw axis of V[ph, dw, up] (the reference's MPI row
  split, ED_HAMILTONIAN_NORMAL.f90:129-142); on the fused layout the padded
  dw rows of V3[j, d, c]. ``V·Hupᵀ`` is local; the dw hops and the
  non-local terms read the gathered vector (:meth:`Mesh.all_gather_rows`,
  the MPI_Allgatherv of the reference);
* joint sectors: the electronic rows of the padded-ELL tables
  (ED_SUPERC/ED_HAMILTONIAN_SUPERC_STORED_HxV.f90:366-432), or the dw rows
  of every (Nup, Ndw) block of the blocked Kron (edipack_tpu's
  JointKronMatvec under a mesh);
* dense eigh buckets: each rank diagonalizes its share of a chunk.

The caller initializes the default process group (``torchrun``, or
``torch.distributed.init_process_group`` with a ``timeout``); the solver
never does (the C libraries join one from their environment,
capihelp.join_group). :func:`make_mesh` returns None without a group of
more than one rank, and every code path then runs as before. Collectives
on CUDA tensors run where the backend takes them (NCCL); under gloo,
which is what two ranks sharing one card need, they are staged through
host tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the JAX package's sector-selection rule (edipack_tpu/solver/core.py:271-273
# and core_joint.py:680): a sector is split when it is this many times the
# dense threshold
SHARD_FACTOR = 4

n_gathers = 0       # all_gather_rows calls of every mesh since the last reset
n_reduces = 0       # allreduce_sum calls


def shard_normal(dim: int, dim_dw: int, lanc_dim_threshold: int,
                 world: int) -> bool:
    """Whether a normal sector's dw axis is split over ``world`` ranks."""
    return dim > SHARD_FACTOR * lanc_dim_threshold and dim_dw % world == 0


def shard_joint(dim: int, lanc_dim_threshold: int) -> bool:
    """Whether a joint sector's rows are split: the ELL's electronic rows,
    or the dw rows of every block of the blocked Kron."""
    return dim > SHARD_FACTOR * lanc_dim_threshold


class MeshError(RuntimeError):
    """The ranks of a mesh disagree on what they are about to compute."""


class Mesh:
    """One rank's view of a process group: rank, world size, group and the
    solve's device, and the collectives the sharded solve needs."""

    def __init__(self, device, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        # gloo takes CPU tensors: stage CUDA tensors through the host
        self.staged = self.backend == "gloo" and self.device.type != "cpu"

    def __repr__(self) -> str:
        return (f"Mesh(backend={self.backend}, world={self.world}, "
                f"rank={self.rank}, device={self.device}"
                f"{', host-staged' if self.staged else ''})")

    def rows(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """This rank's (or rank ``rank``'s) rows [lo, hi) of an axis of
        length ``n``: blocks of ceil(n / world), the last one short (or
        empty)."""
        chunk = -(-n // self.world)
        lo = min(n, (self.rank if rank is None else rank) * chunk)
        return lo, min(n, lo + chunk)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``t`` (a new tensor on ``t``'s device); the
        sum is the same, bit for bit, on every rank."""
        global n_reduces
        n_reduces += 1
        h = t.cpu() if self.staged else t.clone()
        dist.all_reduce(h, group=self.group)
        return h.to(t.device)

    def all_gather_rows(self, x: torch.Tensor, n: int, axis: int
                        ) -> torch.Tensor:
        """The whole axis ``axis`` (length ``n``) from every rank's row
        block ``x`` of it (:meth:`rows`). The blocks travel as one
        contiguous piece a rank, and are put in place on ``x``'s device."""
        global n_gathers
        n_gathers += 1
        axis = axis % x.dim()
        chunk = -(-n // self.world)
        xt = x.movedim(axis, 0)
        if xt.shape[0] < chunk:
            xt = torch.cat([xt, xt.new_zeros(chunk - xt.shape[0],
                                             *xt.shape[1:])])
        flat = self._host(xt.contiguous().reshape(-1))
        full = flat.new_empty(self.world * flat.numel())
        dist.all_gather(list(full.chunk(self.world)), flat, group=self.group)
        full = full.to(x.device).view(self.world * chunk, *xt.shape[1:]).narrow(0, 0, n)
        return full.movedim(0, axis)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on every rank), stacked on a new
        leading axis in rank order."""
        h = self._host(x).contiguous()
        parts = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(parts, h, group=self.group)
        return torch.stack(parts).to(x.device)

    def agree(self, what: str, values: Sequence[int]) -> None:
        """Raise :class:`MeshError` on every rank unless every rank passes
        the same ``values``: a rank whose control flow has diverged stops
        here instead of pairing its collectives with the wrong ones."""
        mine = torch.as_tensor([int(v) for v in values], dtype=torch.int64)
        everyone = self.all_gather(mine)
        if not bool((everyone == mine).all()):
            raise MeshError(f"edipack_tpu_torch: ranks disagree on {what}: "
                            f"{everyone.tolist()}")


def make_mesh(device, group=None) -> Optional[Mesh]:
    """The mesh of the initialized process group ``group`` (default: the
    default group) when it has more than one rank, else None (the
    counterpart of the JAX package's ``len(jax.devices()) > 1``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size(group) < 2:
        return None
    return Mesh(device, group)


def is_writer() -> bool:
    """True on the rank that writes files: rank 0 of an initialized
    group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class RowShard:
    """This rank's rows of the middle axis of a flat vector laid out as
    (pre, n, post): ``local`` slices a whole vector (or a (B, dim) block of
    them), ``gather`` rebuilds it from every rank's slice."""

    def __init__(self, mesh: Mesh, pre: int, n: int, post: int):
        self.mesh = mesh
        self.pre, self.n, self.post = pre, n, post
        self.lo, self.hi = mesh.rows(n)
        self.nrows = self.hi - self.lo
        self.dim = pre * n * post
        self.local_dim = pre * self.nrows * post

    def local(self, v: torch.Tensor) -> torch.Tensor:
        lead = v.shape[:-1]
        x = v.reshape(*lead, self.pre, self.n, self.post)
        return x[..., self.lo:self.hi, :].reshape(*lead, self.local_dim)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        lead = v.shape[:-1]
        x = v.reshape(*lead, self.pre, self.nrows, self.post)
        return self.mesh.all_gather_rows(x, self.n, axis=-2).reshape(
            *lead, self.dim)
