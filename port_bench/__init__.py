"""The benchmark of ``mcmc_qec_tpu_torch`` on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness.py`` holds what
every cell shares; ``configs/``, ``traffic/``, ``drivers/`` and
``layer_metrics/`` hold one file a configuration, traffic mix, decoder and
per-layer metric, found by name; ``reference/`` is the plain reference the
timed path's outputs are held against, ``roofline/`` the frozen work counts
of the port's kernels.  Nothing here imports JAX or the JAX package.
"""
