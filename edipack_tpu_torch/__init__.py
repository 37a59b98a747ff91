"""edipack_tpu_torch — the exact-diagonalization impurity solver of
edipack_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The normal-mode solve (``ed_init_solver`` -> ``ed_set_hloc`` -> ``ed_solve``
and the ``ed_get_*`` getters) and the DMFT loop around it (``ed_chi2_fitgf``,
``ed_check_convergence``, ``ed_search_variable``, the bath symmetry helpers,
restart files and ``ed_write_files`` text outputs) run in f64 (or f32 with
``ed_precision="float32"``) on one explicit ``torch.device`` (default
``"cuda"``). Large sectors apply H through the sparse row-gather CUDA kernel
``csrc/row_gather.cu``; the rest through dense Kronecker-factor matmuls.
This package never imports ``jax`` or ``edipack_tpu``.
"""
from .config import EDConfig, default_config, ed_read_input, get_config, set_config
from .main import (
    EDSolver,
    ed_build_impg,
    ed_build_sigma,
    ed_check_convergence,
    ed_chi2_fitgf,
    ed_finalize_solver,
    ed_get_bath_dimension,
    ed_get_delta,
    ed_get_dens,
    ed_get_dimp,
    ed_get_docc,
    ed_get_doubles,
    ed_get_eimp,
    ed_get_evals,
    ed_get_g0and,
    ed_get_g0imp,
    ed_get_gimp,
    ed_get_mag,
    ed_get_neigen_sector,
    ed_get_sigma,
    ed_init_solver,
    ed_read_impgmatrix,
    ed_reset_convergence,
    ed_reset_suffix,
    ed_search_chemical_potential,
    ed_search_variable,
    ed_set_hloc,
    ed_set_neigen_sector,
    ed_set_suffix,
    ed_solve,
)
from .bath.user import (
    ed_break_symmetry_bath,
    ed_enforce_normal_bath,
    ed_orb_equality_bath,
    ed_orb_symmetrize_bath,
    ed_ph_symmetrize_bath,
    ed_ph_trans_bath,
    ed_read_dmft_bath,
    ed_save_array_as_bath,
    ed_set_hgeneral,
    ed_set_hreplica,
    ed_set_hsym_hgeneral,
    ed_set_hsym_hreplica,
    ed_set_linit_hgeneral,
    ed_set_linit_hreplica,
    ed_spin_symmetrize_bath,
)

__all__ = [k for k in dir() if k.startswith("ed_") or k in
           ("EDConfig", "EDSolver", "default_config")]
