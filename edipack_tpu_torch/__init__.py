"""edipack_tpu_torch — the exact-diagonalization impurity solver of
edipack_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The normal-mode solve (``ed_init_solver`` -> ``ed_set_hloc`` -> ``ed_solve``
and the ``ed_get_*`` getters), its extras (susceptibilities with the
``chi*_flag`` inputs, the impurity RDM with ``rdm_flag``, finite
temperature, per-orbital sectors with ``ed_total_ud=False``, runtime
two-body terms, Krylov complexity) and the DMFT loop around it
(``ed_chi2_fitgf``, ``ed_check_convergence``, ``ed_search_variable``, the
bath symmetry helpers, restart files and ``ed_write_files`` text outputs)
run in f64 (or f32 with
``ed_precision="float32"``) on one explicit ``torch.device`` (default
``"cuda"``). Large sectors apply H through the sparse row-gather CUDA kernel
``csrc/row_gather.cu``; the rest through dense Kronecker-factor matmuls.
This package never imports ``jax`` or ``edipack_tpu``.
"""
from .config import EDConfig, default_config, ed_read_input, get_config, set_config
from .main import (
    EDSolver,
    ed_add_twobody_operator,
    ed_build_denschi,
    ed_build_exctchi,
    ed_build_impd,
    ed_build_impf,
    ed_build_impg,
    ed_build_krylov_operator_complexity,
    ed_build_krylov_state_complexity,
    ed_build_pairchi,
    ed_build_self,
    ed_build_sigma,
    ed_build_spinchi,
    ed_check_convergence,
    ed_chi2_fitgf,
    ed_finalize_solver,
    ed_get_argphi,
    ed_get_bath_dimension,
    ed_get_chi,
    ed_get_delta,
    ed_get_denmat,
    ed_get_dens,
    ed_get_denschi,
    ed_get_dimp,
    ed_get_docc,
    ed_get_doubles,
    ed_get_ehartree,
    ed_get_eimp,
    ed_get_eint,
    ed_get_eknot,
    ed_get_ephon,
    ed_get_epot,
    ed_get_evals,
    ed_get_exct,
    ed_get_exctchi,
    ed_get_g0and,
    ed_get_g0imp,
    ed_get_gimp,
    ed_get_imp_info,
    ed_get_impurity_rdm,
    ed_get_koc,
    ed_get_ksc,
    ed_get_mag,
    ed_get_neigen_sector,
    ed_get_nsectors,
    ed_get_pairchi,
    ed_get_phi,
    ed_get_phon,
    ed_get_poc,
    ed_get_psc,
    ed_get_quantum_soc_operators,
    ed_get_rdm,
    ed_get_reduced_rdm,
    ed_get_sigma,
    ed_get_soc,
    ed_get_sp_dm,
    ed_get_spinchi,
    ed_get_ssc,
    ed_init_solver,
    ed_read_denschimatrix,
    ed_read_exctchimatrix,
    ed_read_impdmatrix,
    ed_read_impgmatrix,
    ed_read_pairchimatrix,
    ed_read_spinchimatrix,
    ed_read_umatrix_file,
    ed_reset_convergence,
    ed_reset_suffix,
    ed_reset_umatrix,
    ed_save_umatrix_file,
    ed_search_chemical_potential,
    ed_search_variable,
    ed_set_a_ph,
    ed_set_g_ph,
    ed_set_hloc,
    ed_set_neigen_sector,
    ed_set_suffix,
    ed_solve,
    ed_update_input,
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
