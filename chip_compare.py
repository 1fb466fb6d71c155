"""Time two or more checkouts of the port against each other on one NVIDIA
GPU, in turns, in one call.

    python3 chip_compare.py ROOT_A ROOT_B [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive``).  The roots run one after another, each in
a process of its own that imports ``mcmc_qec_tpu_torch`` from that root
(and builds its kernels there), in the order given, so that
``parent change change parent`` compares two commits on one card.  Per
root it prints:

- the materialised STDC decode at the shape of ``chip_smoke.py`` phase 8
  (toric d=5, B=1024, p=0.1, p_sampling=0.25, droplets=4, steps=450): 30
  decodes after 3 warm-ups, host clock ended by a device synchronise,
  median, quartiles, least and most ms;
- the PTEQ decode of phase 4 (toric d=5, B=2048, p=0.15,
  max_steps=24000, window=600, iters=2, energy_chunk=12): 5 decodes after
  one warm-up, each in ms.

Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def one(root: str) -> int:
    """Time the decodes of the port under ``root``."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", flush=True)
        return 1
    import mcmc_qec_tpu_torch
    from mcmc_qec_tpu_torch.decoders import PTEQ, STDC, PTEQConfig
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing

    where = Path(mcmc_qec_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        print(f"imported {where}, not the package under {root}", flush=True)
        return 1
    spec = get_spec("toric", 5)
    gen = torch.Generator(device="cuda").manual_seed(2027)
    states = sample_depolarizing(gen, spec, 0.1, (1024,), device="cuda")

    def stdc(seed):
        return STDC(spec, states, 0.1, 0.25, droplets=4, steps=450, seed=seed,
                    device="cuda")

    for _ in range(3):
        stdc(1)
    ms = sorted(_timed(lambda: stdc(3)) for _ in range(30))
    q1, _, q3 = statistics.quantiles(ms, n=4)
    print(f"{root} STDC ms: median {statistics.median(ms):.2f} q1 {q1:.2f} "
          f"q3 {q3:.2f} min {ms[0]:.2f} max {ms[-1]:.2f}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2026)
    pstates = sample_depolarizing(gen, spec, 0.15, (2048,), device="cuda")
    cfg = PTEQConfig(max_steps=24000, window=600, iters=2, energy_chunk=12)

    def pteq():
        return PTEQ(spec, pstates, 0.15, cfg, seed=7, device="cuda")

    pteq()
    tp = [_timed(pteq) for _ in range(5)]
    print(f"{root} PTEQ ms: {' '.join(f'{x:.1f}' for x in tp)}", flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        return one(argv[1])
    if len(argv) < 2:
        print(__doc__)
        return 2
    rc = 0
    for root in argv:
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", str(Path(root).resolve())])
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
