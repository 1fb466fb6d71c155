from .dense_sweep import make_dense_sweep
from .engines import VALID_ENGINES, resolve_device, resolve_engine
from .ladder_window import (
    ladder_window_counts,
    ladder_window_reference,
    make_ladder_window,
)
from .metropolis import make_chain_stepper, make_chain_update, make_sweep_stepper
from .pauli import (
    all_class_states,
    anticommute,
    apply_stabilizers_uniform,
    bit_planes,
    class_bits,
    count_errors,
    count_errors_xyz,
    eq_class,
    make_hash_mults,
    pack_key,
    random_logical,
    syndrome,
    to_class,
)
from .philox import philox4x32
from .sweep import (
    make_recording_sweep,
    make_sweep,
    sample_reference,
    sweep_counts,
    sweep_reference,
)
