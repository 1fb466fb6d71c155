"""mcmc_qec_tpu_torch: the PyTorch and CUDA port of mcmc_qec_tpu.

Same layout and module names as the JAX package, which stays the reference
every part of the port is tested against (tests/test_torch_*.py).  Ported so
far: the code families; the PTEQ decoders for depolarizing, biased and
alpha noise with shortest-chain tracking (``decoders.PTEQ``,
``PTEQ_biased``, ``PTEQ_alpha``, ``PTEQ_alpha_with_shortest``) and their
fused parallel-tempering window (CUDA kernel ``csrc/ladder_window.cu``,
every branch); the exact posterior ``decoders.exact_mld``; the counting
decoders STDC and STRC
(``decoders.STDC``, ``decoders.STRC``), materialised or through the
bounded-memory streaming reduction (``decoders/streaming.py``), with the
``conv_mult`` early-stop rule, and their colored Metropolis sweep (CUDA
kernel ``csrc/sweep.cu``); structured metrics (``utils.metrics``).  The kernels are built with nvcc at first
use on a CUDA device; entry points run on the card unless the caller asks
for the CPU.  Importing this package imports neither jax nor triton.
"""

from . import models

__version__ = "0.1.0"
