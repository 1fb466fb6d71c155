from .engines import VALID_ENGINES, resolve_engine
from .ladder_window import (
    ladder_window_counts,
    ladder_window_reference,
    make_ladder_window,
)
from .pauli import (
    anticommute,
    bit_planes,
    class_bits,
    count_errors,
    count_errors_xyz,
    eq_class,
    syndrome,
)
from .philox import philox4x32
