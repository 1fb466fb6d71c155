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
  instructions), and the registers and spilled bytes of each instantiation
  of both kernels' large variants (ptxas);
- K2's register form: one production window (W=600, iters=2, C=12, zero
  top rung) at the smoke check's shapes: toric d=5 B=2048, toric d=13
  B=512, xzzx d=13 B=512 (general betas) and toric d=21 B=64;
- K2's large variant (``ops/ladder_window.py::window_form``): one W=60
  window at toric d=23 B=16, toric d=25 B=128 and B=1024, xzzx d=33 B=64
  (general betas) and rotated d=37 B=128, each with its launch (lanes per
  rung, threads, syndromes per block, and the blocks an SM holds by the
  occupancy calculator); at toric d=25 B=128 the same window at 0, 1 and
  2 sweeps a step, and, where the root has the qubit table, with that
  table in device memory instead of shared memory and at other lane
  counts (8, 16, 32 at B=128; 2, 4, 8 at B=1024);
- both forms, each forced, on one production window at the 16-word
  shapes (toric d=21 B=64, rotated d=29 B=128) and the 12-word shapes
  (toric d=17 B=64, toric d=19 B=512, rotated d=27 B=128, xzzx d=25 B=512
  general), and for the record below 12 words (toric d=15 and d=13 and
  xzzx d=13 at B=512, toric d=5 at B=2048): the measurement
  ``window_form``'s rule rests on;
- two decodes through ``PTEQ``: toric d=23 B=16 cap 1200 and
  ``PTEQ_alpha`` xzzx d=33 eta=10 p=0.20 B=64 cap 12,000 (the smoke
  check's phase 28 (c) inputs), with their window, K2 launches and a
  SHA-256 of every array of the result, so two roots' lines show equal
  results;
- K1: the 450-step sampler over 65,536 toric d=5 chains, and its large
  variant: 10 sweeps of 16,384 toric d=45 chains, the samplers at toric
  d=25 (40,960 chains x 40 steps, at one and two sweeps a step, and at 1,
  2, 4 and 8 lanes a chain; and its 40 sweeps without the recording) and
  rotated d=45 (5,120 x 150), the PTDC
  ladder step at toric d=23 (5,888 chains, a row of betas each) and the
  unfused PTEQ ladder step's sweeps there (368 chains), each with its
  launch (lanes, threads, blocks, and the blocks an SM holds by the
  occupancy calculator);
- decodes through K1's large variant with a SHA-256 of the result: STDC
  at toric d=25 B=256 and rotated d=45 B=128 (10 droplets x 1500 steps)
  and PTDC at toric d=23 B=16 (the smoke check's phase 27 (c) inputs),
  with their seconds and K1 launches.

Each time is CUDA events around 2-5 launches after a warm-up, in ms.
Needs a CUDA device; imports no jax.

    python3 chip_window_probe.py --forms FAMILY D B ITERS P

times K2's two forms alone, each forced, on one production window (W=600,
C=12, Nc=D rungs of ``beta_ladder_depolarizing(P, D)``, a zero top rung)
at ``ITERS`` sweeps a step, in this checkout, and says whether every
output of the two is equal (the shape ``window_form`` decides between,
e.g. ``--forms toric 13 512 10 0.19``, the threshold study's window at
the upstream's iters).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import re
import subprocess
import sys
import time
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


def ptxas_lines(log: str):
    """'kernel<a, ...>: N registers, S bytes spilled' per instantiation, from
    nvcc's -Xptxas -v output."""
    out, name, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"entry function '_ZN3mqt\d+(\w+?)I((?:L[ib]\d+E)+)E", ln)
        if m:
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([ib])(\d+)E", m[2])]
            name = f"{m[1]}<{', '.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m[1]} registers, {spill} bytes spilled")
            name = None
    return out


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
    wide, name, spill = [], None, None
    for ln in built["ladder_window"].log.splitlines():
        if "entry function" in ln:
            m = re.search(r"ladder_window_kernel_wideI((?:L[ib]\d+E)+)E", ln)
            name = m and ", ".join(
                ("true" if v == "1" else "false") if k == "b" else v
                for k, v in re.findall(r"L([ib])(\d+)E", m[1]))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            wide.append(f"wide<{name}>: {m[1]} registers, {spill} bytes spilled")
            name = None
    print(f"{tag} K2 large variant, ptxas: {' | '.join(wide) or 'none'}",
          flush=True)
    k1_wide = [ln for ln in ptxas_lines(built["sweep"].log) if "_wide<" in ln]
    print(f"{tag} K1 large variant, ptxas: {' | '.join(k1_wide) or 'none'}",
          flush=True)

    @contextlib.contextmanager
    def forced(form):
        """Run K2 in ``form`` (or ``window_form``'s pick for None)."""
        pick = lw.window_form
        if form is not None:
            lw.window_form = lambda *args: form
        try:
            yield
        finally:
            lw.window_form = pick

    def ladder(family, d, B, p, seed=5):
        spec = get_spec(family, d)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                                   device="cuda"), d)
        zeros = (torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda"),
                 torch.zeros((B,), dtype=torch.int32, device="cuda"))
        return spec, (ls.state, ls.flag, ls.tops0, *zeros)

    def window(family, d, B, p, W, reps, equal_betas=True, iters=2, form=None):
        spec, state = ladder(family, d, B, p)
        if equal_betas:
            betas, w = beta_ladder_depolarizing(p, d), np.ones(3, np.float32)
        else:
            betas, w = beta_ladder_alpha(p, 2.0, d), np.asarray([2, 2, 1], np.float32)
        betas = torch.as_tensor(betas, dtype=torch.float32, device="cuda")
        with forced(form):
            fn = lw.make_ladder_window(spec, d, W, iters, 0.5, 2, 12,
                                       top_exact=True, equal_betas=equal_betas)
            return _time_ms(lambda: fn(*state, 3, betas, w), reps)

    def plan(family, d, B, equal_betas=True, form=None):
        spec = get_spec(family, d)
        with forced(form):
            shape, n = lw.launch_plan(spec, B, d, 2, equal_betas)
        return (f"L={shape.lanes}, {shape.threads} threads and "
                f"{shape.groups_per_block} syndromes a block, {n} block(s) an "
                f"SM by occupancy, tables in "
                f"{'shared' if shape.tab_in_smem else 'device'} memory")

    for family, d, B, p, eq, reps in (("toric", 5, 2048, 0.15, True, 5),
                                      ("toric", 13, 512, 0.15, True, 3),
                                      ("xzzx", 13, 512, 0.1, False, 3),
                                      ("toric", 21, 64, 0.05, True, 2)):
        ms = window(family, d, B, p, 600, reps, eq, form="registers")
        print(f"{tag} K2 register form, {family} d={d} B={B} W=600 "
              f"{'equal' if eq else 'general'} betas: {ms:.4f} ms", flush=True)

    for family, d, B, eq in (("toric", 23, 16, True), ("toric", 25, 128, True),
                             ("toric", 25, 1024, True), ("xzzx", 33, 64, False),
                             ("rotated", 37, 128, True)):
        ms = window(family, d, B, 0.05, 60, 3, eq)
        print(f"{tag} K2 large variant, {family} d={d} B={B} W=60 "
              f"{'equal' if eq else 'general'} betas: {ms:.4f} ms, "
              f"{ms / 60 * 1e3:.1f} us a step; {plan(family, d, B, eq)}",
              flush=True)
    for iters in (0, 1, 2):
        ms = window("toric", 25, 128, 0.05, 60, 3, iters=iters)
        print(f"{tag} K2 large variant, toric d=25 B=128 W=60 at {iters} "
              f"sweep(s) a step: {ms:.4f} ms", flush=True)

    if hasattr(lw, "qubit_table"):
        @contextlib.contextmanager
        def qubit_table_in_device_memory():
            wide_plan = lw.wide_block_shape

            def in_device(offs, Nc, K, B, n_sm, equal_betas, iters, n_draws):
                shape = wide_plan(offs, Nc, K, B, n_sm, equal_betas, iters,
                                  n_draws)
                return shape._replace(tab_in_smem=False, smem=lw.wide_smem_bytes(
                    offs, Nc, K, shape.groups_per_block, equal_betas, iters,
                    n_draws, False))

            lw.wide_block_shape = in_device
            try:
                yield
            finally:
                lw.wide_block_shape = wide_plan

        with qubit_table_in_device_memory():
            for B in (128, 1024):
                ms = window("toric", 25, B, 0.05, 60, 3)
                print(f"{tag} K2 large variant, toric d=25 B={B} W=60, qubit "
                      f"table in device memory: {ms:.4f} ms", flush=True)

        plan_lanes = lw.wide_lanes
        for B, lanes in ((128, (8, 16, 32)), (1024, (2, 4, 8))):
            for L in lanes:
                lw.wide_lanes = lambda offs, Nc, per_sm: L
                try:
                    ms = window("toric", 25, B, 0.05, 60, 3)
                finally:
                    lw.wide_lanes = plan_lanes
                print(f"{tag} K2 large variant, toric d=25 B={B} W=60 at {L} "
                      f"lanes a rung: {ms:.4f} ms", flush=True)

    for family, d, B, eq in (("toric", 21, 64, True), ("rotated", 29, 128, True),
                             ("toric", 17, 64, True), ("toric", 19, 512, True),
                             ("rotated", 27, 128, True), ("xzzx", 25, 512, False),
                             ("toric", 15, 512, True), ("toric", 13, 512, True),
                             ("xzzx", 13, 512, False), ("toric", 5, 2048, True)):
        spec = get_spec(family, d)
        words = lw.kernel_words(spec.nq)
        times = {form: window(family, d, B, 0.05, 600, 2, eq, form=form)
                 for form in ("registers", "large")}
        print(f"{tag} K2 both forms, {family} d={d} ({words} words) B={B} "
              f"W=600 {'equal' if eq else 'general'} betas: register form "
              f"{times['registers']:.4f} ms, large variant "
              f"{times['large']:.4f} ms ({plan(family, d, B, eq, 'large')}); "
              f"window_form picks {lw.window_form(spec, d, eq, 2)}", flush=True)

    def digest(res):
        h = hashlib.sha256()
        for f in dataclasses.fields(res):
            v = getattr(res, f.name)
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            if isinstance(v, np.ndarray):
                h.update(f.name.encode() + np.ascontiguousarray(v).tobytes())
        h.update(repr((res.buckets, res.window)).encode())
        return h.hexdigest()[:16]

    from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQ_alpha, PTEQConfig
    from mcmc_qec_tpu_torch.models.noise import (
        biased_alpha_equivalent, sample_xyz, xyz_probs_from_biased)
    prod = dict(window=600, iters=2, energy_chunk=12)
    spec = get_spec("toric", 23)
    gen = torch.Generator(device="cuda").manual_seed(2070)
    st = sample_depolarizing(gen, spec, 0.05, (16,))
    lw.ladder_window_counts.reset()
    res = PTEQ(spec, st, 0.05, PTEQConfig(max_steps=1200, **prod), seed=1,
               device="cuda")
    print(f"{tag} PTEQ toric d=23 B=16 cap 1200: window {res.window}, "
          f"{lw.ladder_window_counts.launches} K2 launches, result sha256 "
          f"{digest(res)}", flush=True)
    spec = get_spec("xzzx", 33)
    px, py, pz = xyz_probs_from_biased(0.20, 10.0)
    pz_tilde, alpha = biased_alpha_equivalent(0.20, 10.0)
    gen = torch.Generator(device="cuda").manual_seed(2090)
    st = sample_xyz(gen, spec, px, py, pz, (64,), device="cuda")
    lw.ladder_window_counts.reset()
    res = PTEQ_alpha(spec, st, pz_tilde, alpha, PTEQConfig(max_steps=12000, **prod),
                     seed=1, device="cuda")
    print(f"{tag} PTEQ_alpha xzzx d=33 B=64 cap 12000: window {res.window}, "
          f"{lw.ladder_window_counts.launches} K2 launches, result sha256 "
          f"{digest(res)}", flush=True)

    def states(spec, R, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return sample_depolarizing(gen, spec, 0.3, (R,), device="cuda")

    def launch(spec, R, record, equal_betas):
        """The launch at R chains: lanes, threads, blocks, blocks an SM."""
        plan, n = sw.launch_plan(spec, R, record, equal_betas)
        threads = getattr(plan, "threads", 256)
        return (f"L={plan.lanes}, {threads} threads and "
                f"{plan.chains_per_block} chains a block, "
                f"{-(-R // plan.chains_per_block)} blocks, {n} block(s) an SM "
                f"by occupancy")

    def sampler(family, d, R, steps, iters=1):
        spec = get_spec(family, d)
        st = states(spec, R, 44)
        seeds = torch.randint(0, 2**31 - 1, (steps,),
                              generator=torch.Generator().manual_seed(44))
        b = torch.full((3,), 1.7, device="cuda")
        fn = sw.make_recording_sweep(spec, steps, iters, equal_betas=True)
        return _time_ms(lambda: fn(st, seeds, b), 3), launch(spec, R, True, True)

    def per_chain(d, R, record, reps):
        """The PT ladder step's launch at toric d: a row of betas a chain,
        general betas; one recorded step of one sweep (PTDC) or two sweeps
        (the unfused PTEQ window)."""
        spec = get_spec("toric", d)
        st = states(spec, R, 7)
        b = torch.rand((R, 3), generator=torch.Generator(device="cuda").manual_seed(3),
                       device="cuda") * 2 + 0.2
        if record:
            fn = sw.make_recording_sweep(spec, 1, 1, equal_betas=False)
            seeds = torch.tensor([12345], dtype=torch.int64)
            run = lambda: fn(st, seeds, b)  # noqa: E731
        else:
            fn = sw.make_sweep(spec, 2, False)
            run = lambda: fn(st, 12345, b)  # noqa: E731
        return _time_ms(run, reps), launch(spec, R, record, False)

    def sweeps(d, R, n, seed, beta, reps):
        """``make_sweep``: n sweeps of R toric d chains, equal betas."""
        spec = get_spec("toric", d)
        st = states(spec, R, seed)
        fn = sw.make_sweep(spec, n, True)
        b = torch.full((3,), beta, device="cuda")
        return (_time_ms(lambda: fn(st, seed, b), reps),
                launch(spec, R, False, True))

    rows = [("K1 sampler, toric d=5, 65,536 chains x 450 steps",
             sampler("toric", 5, 65536, 450)),
            ("K1 large variant, 10 sweeps of 16,384 toric d=45 chains",
             sweeps(45, 16384, 10, 910, 0.9, 5)),
            ("K1 large variant, sampler toric d=25, 40,960 chains x 40 steps",
             sampler("toric", 25, 40960, 40)),
            ("K1 large variant, 40 sweeps of 40,960 toric d=25 chains, no "
             "recording", sweeps(25, 40960, 40, 44, 1.7, 3)),
            ("K1 large variant, sampler toric d=25, 40,960 chains x 40 steps "
             "of 2 sweeps", sampler("toric", 25, 40960, 40, iters=2)),
            ("K1 large variant, sampler rotated d=45, 5,120 chains x 150 steps",
             sampler("rotated", 45, 5120, 150)),
            ("K1 large variant, PTDC ladder step toric d=23, 5,888 chains",
             per_chain(23, 5888, True, 20)),
            ("K1 large variant, unfused PTEQ ladder sweeps toric d=23, 368 chains",
             per_chain(23, 368, False, 20))]
    for what, (ms, line) in rows:
        print(f"{tag} {what}: {ms:.4f} ms; {line}", flush=True)

    # lanes a chain at toric d=25 (the plan's choice replaced)
    for L in (1, 2, 4, 8):
        saved = sw.lanes_per_chain, getattr(sw, "wide_block", None)
        sw.lanes_per_chain = lambda offs, B, n_sm: L
        if saved[1] is not None:
            sw.wide_block = (lambda spec, record, B, n_sm:
                             saved[1](spec, record, B, n_sm, lanes=L))
        try:
            ms, line = sampler("toric", 25, 40960, 40)
        finally:
            sw.lanes_per_chain, wb = saved
            if wb is not None:
                sw.wide_block = wb
        print(f"{tag} K1 large variant, sampler toric d=25, 40,960 chains x 40 "
              f"steps at {L} lane(s) a chain: {ms:.4f} ms; {line}", flush=True)

    # decodes through K1's large variant, as phase 27 (c) runs them
    from mcmc_qec_tpu_torch.decoders import PTDC, STDC
    from mcmc_qec_tpu_torch.models import np_eq_class

    def decode(fn):
        sw.sweep_counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        arr = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
        return dt, sw.sweep_counts.launches, arr

    for i, (family, d, B) in enumerate((("toric", 25, 256), ("rotated", 45, 128))):
        spec = get_spec(family, d)
        gen = torch.Generator(device="cuda").manual_seed(2050 + i)
        st = sample_depolarizing(gen, spec, 0.05, (B,))
        truth = np_eq_class(spec, st.cpu().numpy())
        STDC(spec, st, 0.05, 0.15, engine="auto", device="cuda", droplets=1,
             steps=30)  # warm-up: the tables and the class seeds' first call
        dt, k1, distr = decode(lambda: STDC(spec, st, 0.05, 0.15, engine="auto",
                                            device="cuda", droplets=10,
                                            steps=1500))
        print(f"{tag} STDC {family} d={d} B={B} 10 x 1500: {dt:.2f} s, {k1} K1 "
              f"launches, recovered {np.mean(distr.argmax(-1) == truth):.4f}, "
              f"result sha256 {hashlib.sha256(distr.tobytes()).hexdigest()[:16]}",
              flush=True)
    spec = get_spec("toric", 23)
    gen = torch.Generator(device="cuda").manual_seed(2080)
    st = sample_depolarizing(gen, spec, 0.05, (16,))
    PTDC(spec, st, 0.05, droplets=1, steps=23 * 2, device="cuda")  # warm-up
    dt, k1, distr = decode(lambda: PTDC(spec, st, 0.05, droplets=1, steps=23 * 20,
                                        device="cuda"))
    print(f"{tag} PTDC toric d=23 B=16: {dt:.2f} s, {k1} K1 launches, result "
          f"sha256 {hashlib.sha256(distr.tobytes()).hexdigest()[:16]}", flush=True)
    return 0


def forms(family: str, d: int, B: int, iters: int, p: float) -> int:
    """Both forms of K2 on one production window at this shape: the launch
    of each, its time, and whether their outputs are equal."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", flush=True)
        return 1
    import mcmc_qec_tpu_torch.ops.ladder_window as lw
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{card.stdout.strip()} | torch {torch.__version__}", flush=True)
    spec = get_spec(family, d)
    gen = torch.Generator(device="cuda").manual_seed(5)
    ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                               device="cuda"), d)
    state = (ls.state, ls.flag, ls.tops0,
             torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda"),
             torch.zeros((B,), dtype=torch.int32, device="cuda"))
    betas = torch.as_tensor(beta_ladder_depolarizing(p, d), dtype=torch.float32,
                            device="cuda")
    w = np.ones(3, np.float32)
    pick, outs = lw.window_form, {}
    for form in ("registers", "large"):
        lw.window_form = lambda *args: form
        try:
            shape, n = lw.launch_plan(spec, B, d, iters, True)
            fn = lw.make_ladder_window(spec, d, 600, iters, 0.5, 2, 12,
                                       top_exact=True, equal_betas=True)
            outs[form] = fn(*state, 3, betas, w)
            ms = _time_ms(lambda: fn(*state, 3, betas, w), 2)
        finally:
            lw.window_form = pick
        print(f"K2 {form}, {family} d={d} B={B} Nc={d} iters={iters} W=600: "
              f"{ms:.4f} ms; L={shape.lanes}, {shape.threads} threads and "
              f"{shape.groups_per_block} syndromes a block, {shape.smem} B of "
              f"shared memory, {n} block(s) an SM by occupancy, "
              f"{lw.resident_rows(shape, n, lw._sm_count(torch.device('cuda')))}"
              f" rows at once", flush=True)
    same = [torch.equal(a, b) for a, b in zip(outs["registers"], outs["large"])]
    print(f"K2 both forms, {family} d={d} B={B} iters={iters}: outputs "
          f"{'equal' if all(same) else 'DIFFER'} ({sum(same)} of {len(same)} "
          f"equal); window_form picks {pick(spec, d, True, iters)}", flush=True)
    return 0 if all(same) else 1


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        return one(argv[1])
    if len(argv) == 6 and argv[0] == "--forms":
        return forms(argv[1], int(argv[2]), int(argv[3]), int(argv[4]),
                     float(argv[5]))
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
