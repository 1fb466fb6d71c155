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
  top rung) at toric d=5 B=2048, xzzx d=13 B=512 (general betas) and
  toric d=11 B=512 (4 words, the most a register build holds);
- K2's large variant (``ops/ladder_window.py::window_form``): one W=60
  window at toric d=23 B=16, toric d=25 B=128 and B=1024, xzzx d=33 B=64
  (general betas) and rotated d=37 B=128, each with its launch (lanes per
  rung, threads, syndromes per block, and the blocks an SM holds by the
  occupancy calculator); at toric d=25 B=128 the same window at 0, 1 and
  2 sweeps a step, and, where the root has the qubit table, with that
  table in device memory instead of shared memory and at other lane
  counts (8, 16, 32 at B=128; 2, 4, 8 at B=1024);
- both forms, each forced, on one production window at toric d=11 and
  d=9 and xzzx d=13 at B=512 and toric d=5 at B=2048 (the shapes with a
  register build, ``WINDOW_SHAPES``);
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
e.g. ``--forms toric 11 512 10 0.19``); a code without a register build
(``WINDOW_SHAPES``: 6 words a plane and more) is refused.

    python3 chip_window_probe.py --grid fit|check [OUT.jsonl]

times both forms the same way over ``GRIDS``' shapes at iters 2 and 10:
"fit" (toric d = 5 ... 15 at several batches, xzzx and rotated d = 9, 13,
17 at B=512 in both betas forms) is the measurement ``window_form``'s rule
rests on, "check" shapes its fit did not see; one JSON record a shape in
OUT (``chiprun_out/window_forms_<grid>.jsonl``).
At the shapes without a register build only the large variant runs.

    python3 chip_window_probe.py --lanes [OUT.jsonl]

times K2's register form, forced, at ``lanes_per_rung``'s lanes a rung
and every power of two above up to 32 (where a block holds the group;
``window_lanes`` takes 2 or 4 times the default) on one production
window (W=600, C=12, a zero top rung) over ``LANES_GRID``' shapes at
iters 10 and 2: toric d=5 at Nc=5, p 0.15 and 0.19, B from 16 to 2603,
and the other register-form ladders, toric d=7 and xzzx d=13 (general
betas) at B 132, 512 and 2048; per lane count its time (two passes, the
lane counts in turn and back), launch and rows held at once, whether every
output equals the default lanes' output, and the lanes ``window_lanes``
picks; one JSON record a shape and iters in OUT
(``chiprun_out/window_lanes.jsonl``).  ``window_lanes``' table rests on it.
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


def picks(window_form, spec, Nc: int, equal_betas: bool, iters: int, B: int,
          n_sm: int = 132):
    """The form ``window_form`` picks for B rows, in a checkout whose rule
    reads the batch, or the form it picks whatever the batch in one whose
    rule does not."""
    try:
        return window_form(spec, Nc, equal_betas, iters, B, n_sm)
    except TypeError:
        return window_form(spec, Nc, equal_betas, iters)


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
                                      ("xzzx", 13, 512, 0.1, False, 3),
                                      ("toric", 11, 512, 0.15, True, 3)):
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

    for family, d, B, eq in (("toric", 11, 512, True), ("toric", 9, 512, True),
                             ("xzzx", 13, 512, False), ("toric", 5, 2048, True)):
        spec = get_spec(family, d)
        words = lw.kernel_words(spec.nq)
        times = {form: window(family, d, B, 0.05, 600, 2, eq, form=form)
                 for form in ("registers", "large")}
        print(f"{tag} K2 both forms, {family} d={d} ({words} words) B={B} "
              f"W=600 {'equal' if eq else 'general'} betas: register form "
              f"{times['registers']:.4f} ms, large variant "
              f"{times['large']:.4f} ms ({plan(family, d, B, eq, 'large')}); "
              f"window_form picks {picks(lw.window_form, spec, d, eq, 2, B)}",
              flush=True)

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
    import mcmc_qec_tpu_torch.ops.kernel_tables as kt
    import mcmc_qec_tpu_torch.ops.ladder_window as lw
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing

    spec = get_spec(family, d)
    if not lw.has_window_shape(spec):
        print(f"{family} d={d}: {kt.kernel_words(spec.nq)} words a plane, no "
              f"register build (WINDOW_SHAPES {lw.WINDOW_SHAPES})", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{card.stdout.strip()} | torch {torch.__version__}", flush=True)
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
              f"{lw.resident_rows(shape, n, kt._sm_count(torch.device('cuda')))}"
              f" rows at once", flush=True)
    same = [torch.equal(a, b) for a, b in zip(outs["registers"], outs["large"])]
    print(f"K2 both forms, {family} d={d} B={B} iters={iters}: outputs "
          f"{'equal' if all(same) else 'DIFFER'} ({sum(same)} of {len(same)} "
          f"equal); window_form picks {picks(pick, spec, d, True, iters, B)}",
          flush=True)
    return 0 if all(same) else 1


# (family, d, batches, betas) of ``--grid``, each at iters 2 and 10.  "fit":
# toric at the depolarizing grid's sizes near its threshold, with the d=5
# cells' corpus-sized batch and the compacted tails of their decodes; xzzx
# and rotated at B=512 in both betas forms (general: ``PTEQ_alpha`` at
# eta=10).  "check": shapes the fit of ``WAVE_COST`` did not see, every
# other (words, span) of the register instantiations, the study's
# compacted d=13 batches and batches past a wave
GRIDS = {
    "fit": ([("toric", 5, (16, 64, 132, 300, 512, 1024, 2048, 2603), "equal")]
            + [("toric", d, (64, 132, 512, 2048), "equal")
               for d in (7, 9, 11, 13, 15)]
            + [(f, d, (512,), b) for f in ("xzzx", "rotated") for d in (9, 13, 17)
               for b in ("equal", "general")]),
    "check": ([("planar", d, (512,), "equal") for d in (9, 11, 13, 15)]
              + [("rotated", d, (512,), "equal") for d in (11, 15, 19, 21)]
              + [("xzzx", d, (512,), "general") for d in (11, 15, 19, 21)]
              + [("xzzx", 17, (132,), "general"),
                 ("xzzx", 13, (132, 2048), "general"),
                 ("toric", 13, (128, 256, 1024), "equal"),
                 ("toric", 5, (4096,), "equal"),
                 ("toric", 7, (1024, 4096), "equal")]),
}
GRID_P = {"toric": 0.19, "planar": 0.19, "rotated": 0.19, "xzzx": 0.276}


def grid(name: str, out_path: str) -> int:
    """Both forms of K2, each forced, on one production window (W=600,
    C=12, Nc=d, a zero top rung) at every shape of ``GRIDS[name]`` and
    iters 2 and 10:
    each form's time, launch and rows held at once (the occupancy
    calculator's blocks an SM), whether all outputs are equal, and the form
    ``window_form`` picks; one line a shape, and one JSON record a shape in
    ``out_path``."""
    import json

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", flush=True)
        return 1
    import mcmc_qec_tpu_torch.ops.kernel_tables as kt
    import mcmc_qec_tpu_torch.ops.ladder_window as lw
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_alpha,
                                                 beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import (biased_alpha_equivalent,
                                                 sample_depolarizing)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{card.stdout.strip()} | torch {torch.__version__}", flush=True)
    from mcmc_qec_tpu_torch.ops import _build

    built = _build.build("ladder_window")
    print(f"K2 build {built.seconds:.1f} s, ptxas: "
          f"{' | '.join(ptxas_lines(built.log)) or 'reused build'}", flush=True)
    dev = torch.device("cuda")
    n_sm = kt._sm_count(dev)
    pick, bad = lw.window_form, 0
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as log:
        for family, d, batches, kind in GRIDS[name]:
            spec, p = get_spec(family, d), GRID_P[family]
            eq = kind == "equal"
            if eq:
                betas, w = beta_ladder_depolarizing(p, d), np.ones(3, np.float32)
            else:
                pzt, alpha = biased_alpha_equivalent(p, 10.0)
                betas = beta_ladder_alpha(pzt, alpha, d)
                w = np.asarray([alpha, alpha, 1.0], np.float32)
            betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
            for B in batches:
                gen = torch.Generator(device="cuda").manual_seed(5 + B)
                ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                                           device="cuda"), d)
                state = (ls.state, ls.flag, ls.tops0,
                         torch.zeros((B, spec.n_classes), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((B,), dtype=torch.int32, device=dev))
                for iters in (2, 10):
                    rec = dict(family=family, d=d, B=B, iters=iters,
                               betas=kind, nw=kt.kernel_words(spec.nq),
                               span=kt.spanned_words(spec))
                    outs = {}
                    for form in ("registers", "large"):
                        if form == "registers" and not lw.has_window_shape(spec):
                            rec[form] = None  # no register build here
                            continue
                        lw.window_form = lambda *args: form
                        try:
                            shape, n = lw.launch_plan(spec, B, d, iters, eq)
                        except ValueError:  # the form does not hold it
                            rec[form] = None
                            lw.window_form = pick
                            continue
                        try:
                            fn = lw.make_ladder_window(
                                spec, d, 600, iters, 0.5, 2, 12,
                                top_exact=True, equal_betas=eq)
                            first = time.perf_counter()
                            outs[form] = fn(*state, 3, betas, w)
                            torch.cuda.synchronize()
                            first = 1e3 * (time.perf_counter() - first)
                            reps = 1 if first > 250 else min(5, 1 + int(500 / first))
                            ms = _time_ms(lambda: fn(*state, 3, betas, w), reps)
                        finally:
                            lw.window_form = pick
                        rec[form] = dict(
                            ms=round(ms, 4), lanes=shape.lanes,
                            threads=shape.threads,
                            groups=shape.groups_per_block, smem=shape.smem,
                            blocks_per_sm=n,
                            rows_at_once=lw.resident_rows(shape, n, n_sm))
                    same = [torch.equal(a, b) for a, b in
                            zip(outs.get("registers", ()), outs["large"])]
                    bad += not all(same)
                    rec.update(equal=sum(same), outputs=len(same),
                               pick=picks(pick, spec, d, eq, iters, B, n_sm))
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                    said = {f: "not built or does not hold it" if r is None else
                            f"{r['ms']:.3f} ms ({r['rows_at_once']} rows at "
                            f"once)" for f, r in rec.items()
                            if f in ("registers", "large")}
                    print(f"{family} d={d} ({rec['nw']} words, span "
                          f"{rec['span']}) B={B} iters={iters} {kind}: "
                          f"registers {said['registers']}, large "
                          f"{said['large']}; {sum(same)}/{len(same)} outputs "
                          f"equal; window_form picks {rec['pick']}",
                          flush=True)
    print(f"grid: {bad} shapes with outputs that differ", flush=True)
    return 1 if bad else 0


# (family, d, betas, p values, batches) of ``--lanes``, each at Nc = d and
# iters 10 and 2: the d=5 cells' ladder over batches up to and past the
# one-wave edges of 4, 8, 16 and 32 lanes a rung (2112, 1056, 660 and 396
# rows), then the other register-form ladders
LANES_GRID = [
    ("toric", 5, "equal", (0.15, 0.19),
     (16, 64, 132, 264, 512, 660, 821, 1056, 1500, 2048, 2603)),
    ("toric", 7, "equal", (0.19,), (132, 512, 2048)),
    ("xzzx", 13, "general", (0.276,), (132, 512, 2048)),
]


def lanes(out_path: str) -> int:
    """K2's register form, forced, at the default lanes a rung and every
    power of two above up to 32 on one production window at every shape of
    ``LANES_GRID``: each lane count's time, launch and rows held at once,
    whether all outputs equal the default lanes', and the lanes
    ``window_lanes`` picks; one line and one JSON record a shape and
    iters."""
    import json

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", flush=True)
        return 1
    import mcmc_qec_tpu_torch.ops.kernel_tables as kt
    import mcmc_qec_tpu_torch.ops.ladder_window as lw
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_alpha,
                                                 beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models import get_spec
    from mcmc_qec_tpu_torch.models.noise import (biased_alpha_equivalent,
                                                 sample_depolarizing)
    from mcmc_qec_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{card.stdout.strip()} | torch {torch.__version__}", flush=True)
    built = _build.build("ladder_window")
    print(f"K2 build {built.seconds:.1f} s, ptxas: "
          f"{' | '.join(ptxas_lines(built.log)) or 'reused build'}", flush=True)
    dev = torch.device("cuda")
    n_sm = kt._sm_count(dev)
    form, rule, bad = lw.window_form, lw.window_lanes, 0
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as log:
        for family, d, kind, ps, batches in LANES_GRID:
            spec, eq = get_spec(family, d), kind == "equal"
            offs = kt.kernel_tables(spec)[2]
            base = kt.lanes_per_rung(offs, d)
            counts = [L for L in (base, 2 * base, 4 * base, 8 * base)
                      if L <= 32 and 32 * -(-d * L // 32) <= lw.MAX_THREADS]
            for p in ps:
                if eq:
                    betas, w = (beta_ladder_depolarizing(p, d),
                                np.ones(3, np.float32))
                else:
                    pzt, alpha = biased_alpha_equivalent(p, 10.0)
                    betas = beta_ladder_alpha(pzt, alpha, d)
                    w = np.asarray([alpha, alpha, 1.0], np.float32)
                betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
                for B in batches:
                    gen = torch.Generator(device="cuda").manual_seed(7 + B)
                    ls = init_ladder(spec, sample_depolarizing(
                        gen, spec, p, (B,), device="cuda"), d)
                    state = (ls.state, ls.flag, ls.tops0,
                             torch.zeros((B, spec.n_classes), dtype=torch.int32,
                                         device=dev),
                             torch.zeros((B,), dtype=torch.int32, device=dev))
                    for iters in (10, 2):
                        fns, rec, outs = {}, {}, {}
                        lw.window_form = lambda *args: "registers"
                        try:
                            for L in counts:
                                lw.window_lanes = lambda *args, L=L: L
                                shape, n = lw.launch_plan(spec, B, d, iters, eq)
                                fn = lw.make_ladder_window(
                                    spec, d, 600, iters, 0.5, 2, 12,
                                    top_exact=True, equal_betas=eq)
                                fns[L] = lambda fn=fn: fn(*state, 3, betas, w)
                                first = time.perf_counter()
                                outs[L] = fns[L]()
                                torch.cuda.synchronize()
                                first = 1e3 * (time.perf_counter() - first)
                                held = lw.resident_rows(shape, n, n_sm)
                                rec[L] = dict(
                                    reps=1 if first > 250 else
                                    min(4, 1 + int(300 / first)),
                                    threads=shape.threads,
                                    groups=shape.groups_per_block,
                                    blocks_per_sm=n, rows_at_once=held,
                                    waves=round(B / held, 4), passes=[])
                            # two passes, the lane counts in turn and back
                            for order in (counts, counts[::-1]):
                                for L in order:
                                    lw.window_lanes = lambda *args, L=L: L
                                    rec[L]["passes"].append(round(
                                        _time_ms(fns[L], rec[L]["reps"]), 4))
                        finally:
                            lw.window_form, lw.window_lanes = form, rule
                        for L in counts:
                            rec[L]["ms"] = round(sum(rec[L]["passes"]) / 2, 4)
                            rec[L]["equal"] = sum(torch.equal(a, b) for a, b in
                                                  zip(outs[L], outs[base]))
                        same = all(r["equal"] == len(outs[base])
                                   for r in rec.values())
                        bad += not same
                        row = dict(family=family, d=d, Nc=d, p=p, B=B,
                                   iters=iters, betas=kind, nw=offs["nw"],
                                   span=offs["span"], default=base,
                                   lanes={str(L): r for L, r in rec.items()},
                                   outputs=len(outs[base]), equal=same,
                                   form=form(spec, d, eq, iters, B, n_sm),
                                   pick=rule(spec, d, eq, iters, B, n_sm))
                        log.write(json.dumps(row) + "\n")
                        log.flush()
                        said = ", ".join(
                            f"L={L} {r['ms']:.3f} ms ({r['waves']} waves)"
                            for L, r in rec.items())
                        print(f"{family} d={d} Nc={d} p={p} B={B} iters={iters} "
                              f"{kind}: {said}; outputs "
                              f"{'equal' if same else 'DIFFER'}; window_lanes "
                              f"picks {row['pick']}, window_form {row['form']}",
                              flush=True)
    print(f"lanes: {bad} shapes with outputs that differ", flush=True)
    return 1 if bad else 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        return one(argv[1])
    if len(argv) == 6 and argv[0] == "--forms":
        return forms(argv[1], int(argv[2]), int(argv[3]), int(argv[4]),
                     float(argv[5]))
    if len(argv) in (1, 2) and argv[0] == "--lanes":
        return lanes(argv[1] if len(argv) == 2 else
                     "chiprun_out/window_lanes.jsonl")
    if len(argv) in (2, 3) and argv[0] == "--grid" and argv[1] in GRIDS:
        return grid(argv[1], argv[2] if len(argv) == 3 else
                    f"chiprun_out/window_forms_{argv[1]}.jsonl")
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
