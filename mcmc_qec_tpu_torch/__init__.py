"""mcmc_qec_tpu_torch: the PyTorch and CUDA port of mcmc_qec_tpu.

Same layout and module names as the JAX package, which stays the reference
every part of the port is tested against (tests/test_torch_*.py).  Ported so
far: the code families; the depolarizing PTEQ decoder (``decoders.PTEQ``)
and its fused parallel-tempering window (CUDA kernel
``csrc/ladder_window.cu``); the counting decoders STDC and STRC
(``decoders.STDC``, ``decoders.STRC``) and their colored Metropolis sweep
(CUDA kernel ``csrc/sweep.cu``).  The kernels are built with nvcc at first
use on a CUDA device; entry points run on the card unless the caller asks
for the CPU.  Importing this package imports neither jax nor triton.
"""

from . import models

__version__ = "0.1.0"
