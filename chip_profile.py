"""Where the time of PTEQ decodes, of STDC decodes and of a PTDC decode
goes, on one NVIDIA GPU.

    python3 chip_profile.py

Runs the port's PTEQ at its main path's shape (toric d=5, Nc=5, B=2048,
p=0.15, max_steps=24000, window=600, iters=2, energy_chunk=12) and its STDC
at the shape of the repo's ``stdc_decoder_syndromes_per_sec_d5`` key (toric
d=5, B=1024, p=0.1, p_sampling=0.25, droplets=4, steps=450), and prints:

1. the card, as nvidia-smi names it with its power limit;
2. syndromes/s of three PTEQ decodes in a row (host clock, ended by a
   device synchronise);
3. one PTEQ decode under torch.profiler: host wall time, device busy time
   (the union of the device's kernel and copy intervals), busy share =
   busy / wall, and device time by kernel name;
4. one window of the kernel against the lanes per rung (1, 2, 4, 8) at
   the two main-path shapes: the production branch at toric d=5, Nc=5,
   B=2048 (instantiation <1, 1, true>) and the general branch of the biased
   path at xzzx d=13, Nc=13, B=512 (<3, 2, false>: alpha ladder, exact mix);
5. one window of each against the batch, 64 to 8192, at the default lanes;
6. syndromes/s of three STDC decodes in a row, and one STDC decode under
   torch.profiler (as in 3), split into its sampling loop and its
   reduction, each span ended by a device synchronise; then one launch of
   the recording sampler (450 steps) against the lanes per chain (1, 2, 4,
   8) at the main path's 65,536 chains and at 2,048, and against the batch
   (2,048 to 65,536 chains) at the plan's lanes, with its launch;
7. one PTEQ_alpha decode at the biased path's shape (xzzx d=13, Nc=13,
   B=512, eta=10, p=0.20 as its alpha equivalent, max_steps=32955, the
   production window settings; chip_smoke.py phase 12) unprofiled and
   then under torch.profiler (as in 3), with the host's share of the
   window loop: the part of the wall time in which the device is idle;
8. STDC at the reference's default budget, streamed (toric d=9, B=1024,
   droplets=10, steps=20000, stream="auto": 49 windows of 409 steps;
   chip_smoke.py phase 16) unprofiled and under torch.profiler: busy and
   host share, and the device ms split between the sweep kernel (one
   launch a window), the merge's sorts and its elementwise, gather and
   reduction kernels; then the same budget with conv_mult=2.0 at B=128,
   with the conv_mult automaton's device ms per window (CUDA events,
   ``decoders/streaming.py::stream_timing``);
9. PTDC at the JAX pipeline's defaults (toric d=5, B=1024, droplets=4,
   Nc=5, steps=15625: 3125 ladder steps, streamed; chip_smoke.py phase 18)
   unprofiled and under torch.profiler: busy and host share, device ms by
   kernel kind (the sweep kernel, one launch a ladder step; the merge's
   sorts; the exchange's and the records' elementwise, gather and scatter
   kernels; copies), and the device kernels and the runtime's launch
   calls per ladder step.

Window times are CUDA-event means over 3 launches after one warm-up
(sampler times over 5), with the launch (lanes, threads and syndromes or
chains per block, resident warps per SM) beside each.
Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import mcmc_qec_tpu_torch.ops.ladder_window as lw
import mcmc_qec_tpu_torch.ops.sweep as sw
from chip_smoke import (
    BIASED_MAIN,
    PROD,
    PT_MAIN,
    STDC_MAIN,
    STREAM_MAIN,
    _random_states,
    _sync_time,
    _time_ms,
    launch_line,
    phase_device,
    sampler_launch_line,
    stdc_halves,
)
from mcmc_qec_tpu_torch.decoders import PTDC, PTEQ, STDC, PTEQ_alpha, PTEQConfig
from mcmc_qec_tpu_torch.decoders.streaming import stream_timing
from mcmc_qec_tpu_torch.mcmc.ladder import (
    beta_ladder_alpha,
    beta_ladder_depolarizing,
    betas_depolarizing,
    init_ladder,
)
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.models.noise import (
    biased_alpha_equivalent,
    sample_depolarizing,
    sample_xyz,
    xyz_probs_from_biased,
)

B_MAIN, NC, P = 2048, 5, 0.15


def decode(spec, states):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = PTEQ(spec, states, P, PTEQConfig(max_steps=24000, **PROD), seed=7,
               device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def busy_ms(events) -> float:
    """Length of the union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_decode(spec, states, run=None, name="PTEQ"):
    """One decode (``run(spec, states) -> (result, seconds)``, PTEQ by
    default) under torch.profiler; returns {kernel name: [ms, count]}."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = (run or decode)(spec, states)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms(dev)
    print(f"profiled {name} decode: wall {dt * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, busy share {busy / (dt * 1e3):.3f}, host share "
          f"{1 - busy / (dt * 1e3):.3f}", flush=True)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms:10.3f} ms x {n:4d}  {name[:90]}", flush=True)
    return by_name


def kernel_split(by_name) -> str:
    """Device ms by kind: the sweep kernel, sorts (cub radix and merge
    sorts), copies, and the rest (elementwise, gather/scatter, reductions:
    the merge's rank, sentinel and dedup kernels and the occupancy)."""
    kinds = defaultdict(float)
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "sweep_kernel" in low:
            kinds["sweep kernel"] += ms
        elif "sort" in low or "radix" in low:
            kinds["sorts"] += ms
        elif "memcpy" in low or "memset" in low:
            kinds["copies"] += ms
        else:
            kinds["elementwise/gather/reduce"] += ms
    return ", ".join(f"{k} {v:.1f} ms" for k, v in
                     sorted(kinds.items(), key=lambda kv: -kv[1]))


def stream_decode(spec, states, conv_mult=0.0):
    """STDC at the reference's default budget (stream='auto')."""
    m = STREAM_MAIN
    return _sync_time(lambda: STDC(
        spec, states, m["p"], m["p_sampling"], droplets=m["droplets"],
        steps=m["steps"], seed=3, conv_mult=conv_mult, device="cuda"))


def profile_stream() -> None:
    """Section 8: the streamed STDC at the reference budget."""
    m = STREAM_MAIN
    spec = get_spec("toric", m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2028)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],), device="cuda")
    STDC(spec, states[: m["warm_B"]], m["p"], m["p_sampling"],
         droplets=m["droplets"], steps=m["steps"], seed=1, stream=True,
         device="cuda")
    _, dt = stream_decode(spec, states)
    print(f"streamed STDC toric d={m['d']} B={m['B']} droplets="
          f"{m['droplets']} steps={m['steps']}: {m['B'] / dt:.2f} syn/s "
          f"({dt:.2f} s)", flush=True)
    by_name = profile_decode(spec, states, stream_decode, "streamed STDC")
    print(f"streamed STDC device split: {kernel_split(by_name)}", flush=True)
    Bc = m["conv_mult_B"]
    stream_timing.enabled = True
    try:
        stream_timing.reset()
        _, dt = stream_decode(spec, states[:Bc], conv_mult=2.0)
        split = stream_timing.ms()
        n = stream_timing.windows
    finally:
        stream_timing.enabled = False
    print(f"streamed STDC conv_mult=2.0 B={Bc}: {Bc / dt:.2f} syn/s "
          f"({dt:.2f} s), {n} windows; device ms per window: "
          + ", ".join(f"{k} {v / n:.2f}" for k, v in split.items()),
          flush=True)


def profile_ptdc() -> None:
    """Section 9: PTDC at the JAX pipeline's defaults, streamed."""
    m = PT_MAIN
    spec = get_spec("toric", m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2029)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],), device="cuda")
    n_steps = m["steps"] // m["Nc"]
    kw = dict(droplets=m["droplets"], Nc=m["Nc"], device="cuda")
    PTDC(spec, states[: m["warm_B"]], m["p"], steps=m["Nc"] * m["window"],
         seed=1, stream=True, **kw)

    def run(spec, states):
        return _sync_time(lambda: PTDC(spec, states, m["p"], steps=m["steps"],
                                       seed=3, **kw))

    _, dt = run(spec, states)
    print(f"PTDC toric d={m['d']} B={m['B']} droplets={m['droplets']} "
          f"Nc={m['Nc']} steps={m['steps']} ({n_steps} ladder steps): "
          f"{m['B'] / dt:.2f} syn/s ({dt:.2f} s)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = run(spec, states)
    ev = prof.events()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = busy_ms(dev)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    calls = sum(e.name in ("cudaLaunchKernel", "cudaMemcpyAsync",
                           "cudaMemsetAsync") for e in ev)
    print(f"profiled PTDC decode: wall {dt * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, busy share {busy / (dt * 1e3):.3f}, host share "
          f"{1 - busy / (dt * 1e3):.3f}; {len(dev) / n_steps:.1f} device "
          f"kernels and copies and {calls / n_steps:.1f} runtime launch calls "
          f"per ladder step", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:10.3f} ms x {n:6d}  {name[:90]}", flush=True)
    print(f"PTDC device split: {kernel_split(by_name)}", flush=True)


def stdc_decode(spec, states):
    return _sync_time(lambda: STDC(
        spec, states, STDC_MAIN["p"], STDC_MAIN["p_sampling"],
        droplets=STDC_MAIN["droplets"], steps=STDC_MAIN["steps"], seed=3,
        device="cuda"))


# the window's two main-path shapes: (family, d, Nc, equal betas, batch)
WINDOW_CELLS = {
    "production": ("toric", 5, NC, True, B_MAIN),
    "general": ("xzzx", BIASED_MAIN["d"], BIASED_MAIN["d"], False, BIASED_MAIN["B"]),
}


def window_ms(cell, B, lanes=None, seed=5):
    """ms of one window of ``cell`` at batch ``B`` (the production window
    settings), with ``lanes`` per rung or the default, and its launch."""
    family, d, Nc, equal_betas, _ = WINDOW_CELLS[cell]
    spec = get_spec(family, d)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if equal_betas:
        states = sample_depolarizing(gen, spec, P, (B,), device="cuda")
        ladder, w = beta_ladder_depolarizing(P, Nc), np.ones(3, np.float32)
    else:
        m = BIASED_MAIN
        pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
        states = sample_xyz(gen, spec, *xyz_probs_from_biased(m["p"], m["eta"]),
                            (B,), device="cuda")
        ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
        w = np.array([alpha, alpha, 1.0], np.float32)
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(ladder, dtype=torch.float32, device="cuda")
    default = lw.lanes_per_rung
    try:
        if lanes is not None:
            lw.lanes_per_rung = lambda offs, Nc: lanes
        kern = lw.make_ladder_window(spec, Nc, PROD["window"], PROD["iters"], 0.5,
                                     2, PROD["energy_chunk"], top_exact=True,
                                     equal_betas=equal_betas)
        args = (ls.state, ls.flag, ls.tops0, eq, sb, 3, betas, w)
        kern(*args)
        return _time_ms(lambda: kern(*args), 3), launch_line(spec, B, Nc, equal_betas)
    finally:
        lw.lanes_per_rung = default


def sampler_ms(R, lanes=None):
    """ms of one recording-sampler launch over ``R`` chains of toric d=5
    (the STDC main path's 450 steps of one sweep, equal betas), with
    ``lanes`` per chain or the plan's, and its launch."""
    spec = get_spec("toric", 5)
    states = _random_states(spec, R, seed=9)
    b = torch.as_tensor(betas_depolarizing(STDC_MAIN["p_sampling"]),
                        dtype=torch.float32, device="cuda")
    steps = STDC_MAIN["steps"]
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(8))
    default = sw.lanes_per_chain
    try:
        if lanes is not None:
            sw.lanes_per_chain = lambda offs, B, n_sm: lanes
        rec = sw.make_recording_sweep(spec, steps, 1, equal_betas=True)
        rec(states, seeds, b)
        return (_time_ms(lambda: rec(states, seeds, b), 5),
                sampler_launch_line(spec, R, True))
    finally:
        sw.lanes_per_chain = default


def main() -> int:
    phase_device()
    spec = get_spec("toric", 5)
    gen = torch.Generator(device="cuda").manual_seed(2026)
    states = sample_depolarizing(gen, spec, P, (B_MAIN,), device="cuda")
    for rep in range(3):
        res, dt = decode(spec, states)
        print(f"PTEQ rep {rep}: {B_MAIN / dt:.1f} syn/s ({dt * 1e3:.1f} ms), "
              f"converged {res.converged.mean():.3f}, buckets "
              f"{list(res.buckets)}", flush=True)
    profile_decode(spec, states)

    for cell, (family, d, Nc, _, B) in WINDOW_CELLS.items():
        for lanes in (1, 2, 4, 8):
            ms, launch = window_ms(cell, B, lanes)
            print(f"{cell} window {family} d={d} Nc={Nc} B={B} lanes={lanes}: "
                  f"{ms:.3f} ms/window | {launch}", flush=True)
    for cell, (family, d, Nc, _, _) in WINDOW_CELLS.items():
        for B in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
            ms, launch = window_ms(cell, B)
            print(f"{cell} window {family} d={d} Nc={Nc} B={B:5d} default "
                  f"lanes: {ms:.3f} ms/window | {launch}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2027)
    states = sample_depolarizing(gen, spec, STDC_MAIN["p"], (STDC_MAIN["B"],),
                                 device="cuda")
    for rep in range(3):
        _, dt = stdc_decode(spec, states)
        print(f"STDC rep {rep}: {STDC_MAIN['B'] / dt:.1f} syn/s "
              f"({dt * 1e3:.1f} ms)", flush=True)
    profile_decode(spec, states, stdc_decode, "STDC")
    _, t_sample, t_reduce = stdc_halves(spec, states, seed=3)
    print(f"STDC split: sampling {t_sample * 1e3:.1f} ms, reduction "
          f"{t_reduce * 1e3:.1f} ms, sampling share "
          f"{t_sample / (t_sample + t_reduce):.3f}", flush=True)
    # the recording sampler against the lanes per chain at the main path's
    # 65,536 chains and at the h2h decodes' 2,048 (64 syndromes x 16
    # classes x 2 droplets), then against the batch at the plan's lanes
    R_MAIN = STDC_MAIN["B"] * spec.n_classes * STDC_MAIN["droplets"]
    for R in (R_MAIN, 2048):
        for lanes in (1, 2, 4, 8):
            ms, launch = sampler_ms(R, lanes)
            print(f"sampler toric d=5 R={R} lanes={lanes}: {ms:.3f} ms | "
                  f"{launch}", flush=True)
    for R in (2048, 8192, 16384, 32768, R_MAIN):
        ms, launch = sampler_ms(R)
        print(f"sampler toric d=5 R={R:5d} plan's lanes: {ms:.3f} ms | {launch}",
              flush=True)

    m = BIASED_MAIN
    spec = get_spec("xzzx", m["d"])
    px, py, pz = xyz_probs_from_biased(m["p"], m["eta"])
    pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
    gen = torch.Generator(device="cuda").manual_seed(2028)
    states = sample_xyz(gen, spec, px, py, pz, (m["B"],), device="cuda")
    cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)

    def alpha_decode(spec, states):
        return _sync_time(lambda: PTEQ_alpha(spec, states, pz_tilde, alpha, cfg,
                                             seed=1, device="cuda"))

    lw.ladder_window_counts.reset()
    res, dt = alpha_decode(spec, states)
    print(f"PTEQ_alpha xzzx d={m['d']} B={m['B']}: {m['B'] / dt:.1f} syn/s "
          f"({dt * 1e3:.1f} ms), windows {lw.ladder_window_counts.launches}, "
          f"converged {res.converged.mean():.4f}, buckets {list(res.buckets)}",
          flush=True)
    profile_decode(spec, states, alpha_decode, "PTEQ_alpha")
    profile_stream()
    profile_ptdc()
    return 0


if __name__ == "__main__":
    sys.exit(main())
