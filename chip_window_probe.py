"""Kernel times of the PT window kernel (K2) and the sweep kernel's large
variant (K1) for two or more checkouts of the port, in turns, on one
NVIDIA GPU, in one call.

    python3 chip_window_probe.py ROOT_A ROOT_B [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive``).  The roots run one after another, each in
a process of its own that imports ``mcmc_qec_tpu_torch`` from that root
and builds its kernels there, in the order given, so that ``parent change
change parent`` compares two commits on one card.  Per root it prints:

- the shared-memory atomic instructions in the SASS of both built
  libraries (``cuobjdump -sass``; ``ATOMS.CAST.SPIN.64`` is a
  compare-and-swap loop, ``ATOMS.XOR`` and ``ATOMS.OR`` single
  instructions);
- K2's register form: one production window (W=600, iters=2, C=12, zero
  top rung) at the smoke check's shapes: toric d=5 B=2048, toric d=13
  B=512, xzzx d=13 B=512 (general betas) and toric d=21 B=64;
- K2's large variant, where the checkout has one
  (``ops/ladder_window.py::window_form``): one W=60 window at toric d=23
  B=16, toric d=25 B=128 and B=1024 and rotated d=37 B=128; at toric d=25
  B=128 the same window at 0, 1 and 2 sweeps a step (what the sweeps take
  of a step) and with the tables in shared memory instead of device
  memory;
- K1: the 450-step sampler over 65,536 toric d=5 chains, and its large
  variant: 10 sweeps of 16,384 toric d=45 chains and the samplers at
  toric d=25 (40,960 chains x 40 steps) and rotated d=45 (5,120 x 150).

Each time is CUDA events around 2-5 launches after a warm-up, in ms.
Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import contextlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def one(root: str) -> int:
    """Build and time the kernels of the port under ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", flush=True)
        return 1
    import mcmc_qec_tpu_torch
    import mcmc_qec_tpu_torch.ops.ladder_window as lw
    import mcmc_qec_tpu_torch.ops.sweep as sw
    from mcmc_qec_tpu_torch.mcmc.ladder import (
        beta_ladder_alpha,
        beta_ladder_depolarizing,
        init_ladder,
    )
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing
    from mcmc_qec_tpu_torch.ops import _build

    where = Path(mcmc_qec_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        print(f"imported {where}, not the package under {root}", flush=True)
        return 1
    tag = f"[{Path(root).name}]"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{tag} {card.stdout.strip()} | torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("ladder_window", "sweep"),
                         pool.map(_build.build, ("ladder_window", "sweep"))))
    for name, b in built.items():
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(b.path)],
                              capture_output=True, text=True).stdout
        ops = re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", sass)
        print(f"{tag} {name} library: shared atomics in SASS "
              f"{ {op: ops.count(op) for op in sorted(set(ops))} }", flush=True)

    def ladder(family, d, B, p, seed=5):
        spec = get_spec(family, d)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                                   device="cuda"), d)
        zeros = (torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda"),
                 torch.zeros((B,), dtype=torch.int32, device="cuda"))
        return spec, (ls.state, ls.flag, ls.tops0, *zeros)

    def window(family, d, B, p, W, reps, equal_betas=True, iters=2):
        spec, state = ladder(family, d, B, p)
        if equal_betas:
            betas, w = beta_ladder_depolarizing(p, d), np.ones(3, np.float32)
        else:
            betas, w = beta_ladder_alpha(p, 2.0, d), np.asarray([2, 2, 1], np.float32)
        betas = torch.as_tensor(betas, dtype=torch.float32, device="cuda")
        fn = lw.make_ladder_window(spec, d, W, iters, 0.5, 2, 12, top_exact=True,
                                   equal_betas=equal_betas)
        return _time_ms(lambda: fn(*state, 3, betas, w), reps)

    for family, d, B, p, eq, reps in (("toric", 5, 2048, 0.15, True, 5),
                                      ("toric", 13, 512, 0.15, True, 3),
                                      ("xzzx", 13, 512, 0.1, False, 3),
                                      ("toric", 21, 64, 0.05, True, 2)):
        ms = window(family, d, B, p, 600, reps, eq)
        print(f"{tag} K2 register form, {family} d={d} B={B} W=600 "
              f"{'equal' if eq else 'general'} betas: {ms:.4f} ms", flush=True)

    if hasattr(lw, "window_form"):
        for family, d, B in (("toric", 23, 16), ("toric", 25, 128),
                             ("toric", 25, 1024), ("rotated", 37, 128)):
            ms = window(family, d, B, 0.05, 60, 3)
            print(f"{tag} K2 large variant, {family} d={d} B={B} W=60: {ms:.4f} "
                  f"ms, {ms / 60 * 1e3:.1f} us a step", flush=True)
        for iters in (0, 1, 2):
            ms = window("toric", 25, 128, 0.05, 60, 3, iters=iters)
            print(f"{tag} K2 large variant, toric d=25 B=128 W=60 at {iters} "
                  f"sweep(s) a step: {ms:.4f} ms", flush=True)

        @contextlib.contextmanager
        def tables_in_shared_memory():
            plan = lw.wide_block_shape

            def in_smem(offs, Nc, K, B, n_sm, equal_betas, iters, n_draws):
                smem = lambda g, t: lw.wide_smem_bytes(  # noqa: E731
                    offs, Nc, K, g, equal_betas, iters, n_draws, t)
                return lw._pack_groups(lw.wide_lanes(offs, Nc), Nc, B, n_sm,
                                       smem, True, "tables in shared memory")

            lw.wide_block_shape = in_smem
            try:
                yield
            finally:
                lw.wide_block_shape = plan

        with tables_in_shared_memory():
            for B in (128, 1024):
                ms = window("toric", 25, B, 0.05, 60, 3)
                print(f"{tag} K2 large variant, toric d=25 B={B} W=60, tables "
                      f"in shared memory: {ms:.4f} ms", flush=True)

    def states(spec, R, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return sample_depolarizing(gen, spec, 0.3, (R,), device="cuda")

    def sampler(family, d, R, steps):
        spec = get_spec(family, d)
        st = states(spec, R, 44)
        seeds = torch.randint(0, 2**31 - 1, (steps,),
                              generator=torch.Generator().manual_seed(44))
        b = torch.full((3,), 1.7, device="cuda")
        fn = sw.make_recording_sweep(spec, steps, 1, equal_betas=True)
        return _time_ms(lambda: fn(st, seeds, b), 3)

    spec = get_spec("toric", 45)
    st = states(spec, 16384, 910)
    sweeps = sw.make_sweep(spec, 10, True)
    b = torch.full((3,), 0.9, device="cuda")
    for what, ms in (
            ("K1 sampler, toric d=5, 65,536 chains x 450 steps",
             sampler("toric", 5, 65536, 450)),
            ("K1 large variant, 10 sweeps of 16,384 toric d=45 chains",
             _time_ms(lambda: sweeps(st, 910, b), 5)),
            ("K1 large variant, sampler toric d=25, 40,960 chains x 40 steps",
             sampler("toric", 25, 40960, 40)),
            ("K1 large variant, sampler rotated d=45, 5,120 chains x 150 steps",
             sampler("rotated", 45, 5120, 150))):
        print(f"{tag} {what}: {ms:.4f} ms", flush=True)
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
