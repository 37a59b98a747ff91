from .dmft_bath import (DmftBath, allocate_bath, array_to_bath, bath_to_array,
                        get_bath_dimension, init_bath, bath_levels, bath_hyb,
                        save_bath_file, read_bath_file)
from .replica import ReplicaBasis, make_basis
from .user import (ed_set_hreplica, ed_set_hgeneral, ed_set_linit_hreplica,
                   ed_set_linit_hgeneral, ed_set_hsym_hreplica,
                   ed_set_hsym_hgeneral, ed_read_dmft_bath,
                   ed_spin_symmetrize_bath,
                   ed_orb_symmetrize_bath, ed_break_symmetry_bath,
                   ed_orb_equality_bath, ed_ph_symmetrize_bath,
                   ed_enforce_normal_bath, ed_ph_trans_bath,
                   ed_save_array_as_bath, get_global_basis)
