"""Matching warm starts and the MWPM decoders (numpy and the native
matcher; the port's copy of ``mcmc_qec_tpu.matching``)."""

from .graph import (
    class_sorted_mwpm,
    class_sorted_mwpm_batch,
    enhanced_mwpm,
    generate_classes,
    generate_edges,
    generate_edges_constrained,
    mwpm_correction,
    regular_mwpm,
    regular_mwpm_batch,
    shortest_distance,
    solve_layer,
)
