"""edipack_tpu_torch — the exact-diagonalization impurity solver of
edipack_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The normal-mode solve (``ed_init_solver`` -> ``ed_set_hloc`` -> ``ed_solve``
and the ``ed_get_*`` getters) runs in f64 (or f32 with
``ed_precision="float32"``) on one explicit ``torch.device`` (default
``"cuda"``). Large sectors apply H through the sparse row-gather CUDA kernel
``csrc/row_gather.cu``; the rest through dense Kronecker-factor matmuls.
This package never imports ``jax`` or ``edipack_tpu``.
"""
from .config import EDConfig, default_config, ed_read_input, get_config, set_config
from .main import (
    EDSolver,
    ed_finalize_solver,
    ed_get_bath_dimension,
    ed_get_dens,
    ed_get_dimp,
    ed_get_docc,
    ed_get_doubles,
    ed_get_eimp,
    ed_get_evals,
    ed_get_g0imp,
    ed_get_gimp,
    ed_get_mag,
    ed_get_neigen_sector,
    ed_get_sigma,
    ed_init_solver,
    ed_set_hloc,
    ed_set_neigen_sector,
    ed_solve,
)

__all__ = [k for k in dir() if k.startswith("ed_") or k in
           ("EDConfig", "EDSolver", "default_config")]
