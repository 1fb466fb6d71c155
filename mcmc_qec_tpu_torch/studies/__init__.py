"""The studies of the port: each module is the port's copy of one
script of ``examples/`` that drives the JAX package, with the script's
flags, defaults, output lines and JSON records, plus ``--device`` (``cuda``,
the default, raising without a card; ``cpu`` runs the kernels' plain
versions).  Each runs as ``python -m mcmc_qec_tpu_torch.studies.<name>``.

- ``fss``: the finite-size-scaling fit of a failure-rate grid.
- ``threshold_fit``: depolarizing PTEQ on toric codes over a (d, p) grid
  (``collect``), its fit (``fit``) and figure (``plot``).
- ``threshold_fit_biased``: ``PTEQ_alpha`` on XZZX codes under biased
  noise over a (d, p) grid.
- ``xzzx_eta_sweep``: ``PTEQ_alpha`` on one XZZX code over a p-list.
- ``uncorrelated_study``: MWPM against warm-started ``STDC_general_noise``
  on planar codes through the pipeline.
- ``failure_rates``: STDC failure rates over (d, p).
- ``stepcap_study``: PTEQ at a step cap and at a multiple of it.
- ``compare_decoders``: STDC, STRC, PTDC and PTEQ on the same planar
  syndromes.
- ``head_to_head``: the port's decoders on the cached head-to-head
  syndromes against the reference's distributions (``--phase ours``).
- ``scaling_bench``: STDC over 1, 2, 4 and 8 devices.
- ``golden_replay``, ``golden_ceiling``: PTEQ or STDC on the reference's
  golden failure corpus (``--corpus``, required: the file is not in this
  repository), and the ceiling's MWPM/eMWPM rows; each splits into a
  ``main`` that reads the corpus (pandas) and a ``run`` on the syndromes.

Card results of the threshold studies are under ``studies/results/``.
"""
