"""Cross-decoder comparison (the working version of the reference's
__main__ block, decoders.py:952-1006): decode the same planar syndromes
with STDC / STRC / PTDC / PTEQ and compare class calls and timings.

The port's copy of ``examples/compare_decoders.py``, with its output
lines, plus ``--device``; the syndromes are drawn from a generator on the
device seeded with 0 (the script's ``PRNGKey(0)``).

Run:  python -m mcmc_qec_tpu_torch.studies.compare_decoders [--size 9] [--p 0.1] [--batch 8]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..decoders import PTDC, PTEQ, PTEQConfig, STDC, STRC
from ..models import get_spec, np_eq_class
from ..models.noise import sample_depolarizing
from ..ops.engines import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=9)
    ap.add_argument("--p", type=float, default=0.10)
    ap.add_argument("--p-sampling", type=float, default=0.30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--engine", default="sweep", choices=["literal", "sweep"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = get_spec("planar", args.size)
    steps = args.steps or 10 * args.size**5 // 100
    B = args.batch
    gen = torch.Generator(device=device).manual_seed(0)
    states = sample_depolarizing(gen, spec, args.p, (B,))
    truth = np_eq_class(spec, states.cpu().numpy())
    print(f"planar d={args.size}, p={args.p}, {B} syndromes, "
          f"true classes {truth.tolist()}")

    def report(name, fn):
        t0 = time.perf_counter()
        distr = fn()
        dt = time.perf_counter() - t0
        calls = np.argmax(distr, axis=-1)
        ok = int((calls == truth).sum())
        print(f"{name:6s} {dt:7.1f}s  calls {calls.tolist()}  "
              f"correct {ok}/{B}")
        return calls

    report("STDC", lambda: STDC(spec, states, args.p, args.p_sampling,
                                droplets=4, steps=steps, engine=args.engine,
                                device=device))
    report("STRC", lambda: STRC(spec, states, args.p, args.p_sampling,
                                droplets=4, steps=steps, device=device))
    report("PTDC", lambda: PTDC(spec, states, args.p, args.p_sampling,
                                droplets=2, steps=steps, device=device))
    report("PTEQ", lambda: PTEQ(spec, states, args.p,
                                PTEQConfig(max_steps=50_000, window=200),
                                device=device).distribution)


if __name__ == "__main__":
    main()
