from .dmft_bath import (DmftBath, allocate_bath, array_to_bath, bath_to_array,
                        get_bath_dimension, init_bath, bath_levels, bath_hyb,
                        save_bath_file, read_bath_file)
from .replica import ReplicaBasis, make_basis
