"""mcmc_qec_tpu_torch: the PyTorch and CUDA port of mcmc_qec_tpu.

Same layout and module names as the JAX package, which stays the reference
every part of the port is tested against (tests/test_torch_*.py).  Ported:
the code families; all 13 decoders of the JAX package (``decoders``): PTEQ
for depolarizing, biased and alpha noise with shortest-chain tracking
(``PTEQ``, ``PTEQ_biased``, ``PTEQ_alpha``, ``PTEQ_alpha_with_shortest``),
the counting decoders STDC (four variants) and STRC, the PT counting
decoders PTDC and PTRC, ``single_temp`` and the exact posterior
``exact_mld``; the counting decoders materialised or through the
bounded-memory streaming reduction (``decoders/streaming.py``), with the
``conv_mult`` early-stop rule; the five engine names (``ops/engines.py``):
the fused parallel-tempering window (CUDA kernel
``csrc/ladder_window.cu``), the colored Metropolis sweep (CUDA kernel
``csrc/sweep.cu``, also at a row of betas per chain for the PT ladder
step of ``mcmc/ladder.py``) and the literal single-proposal engine
(``ops/metropolis.py``, plain torch); structured metrics
(``utils.metrics``).  The kernels are built with nvcc at first use on a
CUDA device; entry points run on the card unless the caller asks for the
CPU.  Importing this package imports neither jax nor triton.
"""

from . import models

__version__ = "0.1.0"
