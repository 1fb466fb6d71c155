"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both kernels from mcmc_qec_tpu_torch/csrc with nvcc (one process per
source, started together), then drives each ported path and holds each
kernel against its plain PyTorch version on the card:

- K2, the PT window (csrc/ladder_window.cu): kernel vs plain version,
  also with a ragged last block, at 1 to 32 lanes per rung and with
  multi-warp groups; depolarizing PTEQ at production size through the
  kernel; the 64 cached head-to-head syndromes against the executing
  reference; one window timed against one of the plain version at the
  main path's shape, outputs equal, with its launch (lanes, threads and
  syndromes per block, resident warps per SM).
- K1, the colored sweep (csrc/sweep.cu), in both its modes: sweeps with
  states in and out, and the counting decoders' whole recording sampler in
  one launch.  Kernel vs plain version (both acceptance branches, toric
  d=5 ragged, planar d=3, toric d=13 to d=19, 1 and 3 sweeps per step);
  STDC at the shape of the repo's ``stdc_decoder_syndromes_per_sec_d5`` key
  through one sampler launch, with the split between sampling and
  reduction and the same percentages as the per-step loop the sampler
  replaces; STDC and STRC on the 64 cached syndromes against the reference
  and against PTEQ; one sweep, 100 sweeps and the 450-step sampler timed
  at the main path's shape against the plain versions (and the sampler
  against the per-step loop), with the launch (lanes and chains per warp,
  resident warps per SM).
- K2's other branches (general-beta sweep, Metropolis logical mix,
  even_odd exchange, traces): kernel vs plain version at 1, 3, 6 and 12
  words per plane, with the tables in device memory (toric d=19 at 25
  rungs); PTEQ_alpha at one cell of the XZZX threshold study
  (xzzx d=13, eta=10, p=0.20) through the kernel against the JAX study's
  failure rate; biased, alpha and even_odd PTEQ and the shortest-chain
  decoder at d=3 against the exact posterior; one general-branch window
  timed against the plain version at that cell's shape.
- The counting decoders' bounded-memory streaming reduction, one K1
  recording launch per stream window with the chains carried between
  windows: STDC, STRC and STDC with conv_mult streamed against the
  materialised decode at the bench key's shape; STDC at the reference's
  default budget (toric d=9, B=1024, droplets=10 x steps=20000, 49 windows)
  with its device-time split, peak memory and overflow bound, and one of
  its window launches against the plain sampler; PTEQ with per-window
  metrics against the same decode without them.
- K1 at a row of betas per chain, the PT ladder step's launch: kernel vs
  plain version (toric d=5 at 327,680 chains, planar d=3 ragged, toric
  d=13 and d=19), and one row per chain equal to the shared row; PTDC and
  PTRC at the JAX pipeline's defaults (toric d=5, B=1024, droplets=4,
  Nc=5, 3125 ladder steps, streamed), one sweep launch per ladder step and
  no plain call, with the device-time split of sweeps, exchanges and
  merges; single_temp at the same shape; PTDC, PTRC, single_temp, STDC on
  the sweep engine and PTEQ on the unfused sweep engine against the exact
  posterior at d=3.

Each phase prints one line; any failed phase exits non-zero.  The line
before the last is a JSON record of the kernels (launches on the main
path, largest difference from the plain version, times, and the least time
the card could take for the same work); the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mcmc_qec_tpu_torch.decoders import (
    PTDC,
    PTEQ,
    PTRC,
    STDC,
    STRC,
    PTEQ_alpha,
    PTEQ_alpha_with_shortest,
    PTEQ_biased,
    PTEQConfig,
    exact_mld,
    single_temp,
)
import mcmc_qec_tpu_torch.decoders.ptdc as ptdc_mod
from mcmc_qec_tpu_torch.decoders.pteq import _shortest_scan, init_shortest
from mcmc_qec_tpu_torch.decoders.counting import SampleStream, sample_classes
import mcmc_qec_tpu_torch.decoders.stdc as stdc_mod
from mcmc_qec_tpu_torch.decoders.stdc import (
    _class_seeds,
    _get_stdc_fn,
    _get_stdc_stream_fn,
    _pick_stream_window,
)
from mcmc_qec_tpu_torch.decoders.streaming import (
    STREAM_BYTES_PER_SAMPLE,
    should_stream,
    stream_deficit_bound,
    stream_timing,
)
from mcmc_qec_tpu_torch.utils.metrics import MetricsLogger
from mcmc_qec_tpu_torch.mcmc.ladder import (
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
    betas_depolarizing,
    betas_xyz,
    init_ladder,
)
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class
from mcmc_qec_tpu_torch.models.noise import (
    biased_alpha_equivalent,
    sample_depolarizing,
    sample_xyz,
    xyz_probs_from_biased,
)
import mcmc_qec_tpu_torch.ops.ladder_window as lw
from mcmc_qec_tpu_torch.ops import _build
from mcmc_qec_tpu_torch.ops.dense_sweep import _color_tables
from mcmc_qec_tpu_torch.ops.ladder_window import (
    _N_EXTRA_USES,
    _rng_layout,
    kernel_tables,
    kernel_words,
    ladder_window_counts,
    ladder_window_reference,
    launch_plan,
    make_ladder_window,
)
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.ops.pauli import count_errors_xyz, make_hash_mults, pack_key
from mcmc_qec_tpu_torch.ops.sweep import (
    make_recording_sweep,
    make_sweep,
    sample_reference,
    sweep_counts,
    sweep_reference,
)

KERNELS = ("ladder_window", "sweep")
ROOT = Path(__file__).resolve().parent
H2H_CACHE = ROOT / "examples" / "h2h_ref_cache_r5.npz"
OUT_NAMES = ("state", "flag", "tops0", "eq_count", "since_burn", "energies",
             "burn_any", "burn_first", "swap_acc", "eq_trace", "key_trace")
# production PTEQ window (bench.py:328-329)
PROD = dict(window=600, iters=2, energy_chunk=12)
# the window's production branch: zero top rung, equal per-Pauli betas
PROD_BRANCH = dict(top_exact=True, equal_betas=True)
# the other branches, as (top_exact, equal_betas): alpha ladders run the
# general sweep with the exact mix, biased ladders the Metropolis mix
BRANCHES = {"general-exact": (True, False), "general-mh": (False, False),
            "equal-exact": (True, True)}
# the biased-noise path: one cell of the XZZX threshold study
# (examples/threshold_fit_biased.py defaults; examples/
# threshold_eta10_r5_pooled.json: JAX failure 0.0767 +- 0.0042 at n=4096,
# converged 0.9985); failure within 0.025 of it (about 3.5 sigma of the
# two samples) and converged >= 0.98
BIASED_MAIN = dict(d=13, eta=10.0, p=0.20, B=512, calls=4, max_steps=32955)
BIASED_REF_FAILURE = 0.0767
BIASED_MAX_FAILURE_GAP = 0.025
BIASED_MIN_CONVERGED = 0.98
# d=3 exact checks (tests/test_decoders.py:141-157): mean TV and argmax
EXACT_CFG = dict(max_steps=24000, window=400, TOPS=30, SEQ=4)
EXACT_MAX_TV = 0.05
# the reference's own run-to-run TV on the 64 cached syndromes
# (RESULTS.md:589-598) and the recovery floor below JAX 52 / reference 54
H2H_MAX_TV = 0.173
H2H_MIN_RECOVERED = 44
# STDC main path: bench.py:150-173 (key stdc_decoder_syndromes_per_sec_d5)
STDC_MAIN = dict(B=1024, p=0.1, p_sampling=0.25, droplets=4, steps=450)
# STDC/STRC on the 64 cached syndromes (head_to_head.py:226-239): mean TV to
# the reference's distributions (JAX 0.302, RESULTS.md:590-591), recovery
# (JAX 49, reference 41/40) and TV to the port's own PTEQ (JAX 0.086,
# RESULTS.md:593)
H2H_COUNTING = dict(p=0.15, p_sampling=0.25, droplets=2, steps=10000, seed=1)
H2H_COUNTING_MAX_TV = 0.35
H2H_COUNTING_MIN_RECOVERED = 44
H2H_STDC_PTEQ_MAX_TV = 0.15
# the streamed STDC/STRC against the materialised decode at STDC_MAIN's
# shape: 8 windows of 64 steps (the last one 2), capacity 4096 >= the 1800
# samples of a row, so nothing can be evicted
STREAM_CHECK = dict(window=64, capacity=4096, conv_mult=2.0, max_diff=1e-3)
# the reference's default budget (decoders.py:268) at toric d=9; stream
# "auto" must resolve to the streaming path; peak memory bound
STREAM_MAIN = dict(d=9, B=1024, p=0.1, p_sampling=0.25, droplets=10,
                   steps=20000, warm_B=16, conv_mult_B=128, max_peak_gb=40.0,
                   big_capacity=32768)
# PTDC and PTRC at the JAX pipeline's defaults (pipeline/config.py:18-36):
# toric d=5, p_error=0.1, p_sampling = p_error, droplets=4, Nc=d, steps =
# 5 d**5 = 15625 (3125 ladder steps); B=1024 gives 16,384 (syndrome, class)
# rows and 327,680 chains a sweep; stream="auto" streams both.  The
# warm-up runs one stream window at B=16; single_temp at the same shape
# records the pipeline's steps; truth recovery must reach 0.8.
PT_MAIN = dict(d=5, B=1024, p=0.1, droplets=4, Nc=5, steps=15625, warm_B=16,
               window=256, min_recovered=0.8, capacity_B=64)
# the JAX tests' d=3 syndromes (tests/test_decoders.py:35-40: the JAX
# sampler at PRNGKey(5), p=0.1, and PRNGKey(11), p=0.08), held as data so
# that nothing of JAX runs on the card
D3_SYNDROMES = {
    "planar p=0.1": ("planar", [0, 0, 0, 2, 0, 0, 3, 1, 0, 0, 3, 0, 0, 0, 0, 0,
                                0, 0]),
    "planar p=0.08": ("planar", [0, 3, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0]),
    "toric p=0.1": ("toric", [0, 0, 0, 2, 0, 0, 3, 1, 0, 0, 3, 0, 0, 0, 0, 2,
                              0, 0]),
}
# the materialised stream in the port's form: int64 key halves and int32
# counts, 28 bytes a sample
PORT_BYTES_PER_SAMPLE = 28

# The least time the card could take (the larger of the bytes over the
# memory rate and the operations over their issue rate).  H100 SXM HBM3
# rate (NVIDIA's data sheet); per-SM issue rates per clock for compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions): population count 16, 32-bit integer multiply
# 64.  A 64-bit popcount is two 32-bit POPC instructions in the SASS, and
# Philox4x32-10 is 10 rounds of two mul.hi and two mul.lo (40 IMAD) per
# block of four draws.  The precise logf of a proposal that may be rejected
# depends on the data and is not counted, so the bound is a lower bound.
# Both kernels' proposals popcount only the words the stabilizer's support
# spans, two with equal betas and four with general betas
# (``_popc_per_sweep``); the recording sampler adds three per word of the
# plane and step for the counts and two multiplies per qubit and step for
# the hash (``sampler_bound``).
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLK_SM = 16
IMAD_PER_CLK_SM = 64
POPC_PER_64BIT = 2
IMAD_PER_PHILOX = 40


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)
    return card


def phase_build() -> None:
    """One nvcc per source, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, b in built.items():
        how = f"{b.seconds:.1f} s" if b.seconds else "reused existing build"
        print(f"phase 2 build: {name}.cu {how} | {' | '.join(ptxas_summary(b.log))}",
              flush=True)
        _build.load(name)


def ptxas_summary(log: str):
    """'kernel<a, ...>: N registers, S bytes spilled' per instantiation, from
    nvcc's -Xptxas -v output."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"entry function '_ZN3mqt\d+(\w+?)I((?:L[ib]\d+E)+)E", ln)
        if m:
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([ib])(\d+)E", m[2])]
            name = f"{m[1]}<{', '.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m[1]} registers, {spill} bytes spilled")
            name = None
    return out


def _card_rates():
    """(SM count, highest SM clock in Hz) of device 0."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz * 1e6


def bound_ms(n_bytes: float, popc64: float, philox_blocks: float,
             imad: float = 0.0):
    """(least ms, "bytes" or "operations") for work that moves ``n_bytes``
    and issues ``popc64`` 64-bit popcounts, ``philox_blocks`` Philox blocks
    and ``imad`` other 32-bit multiplies, from the rates above and this
    card's SM count and clock."""
    n_sm, clock = _card_rates()
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(popc64 * POPC_PER_64BIT / (POPC_PER_CLK_SM * n_sm * clock),
                (philox_blocks * IMAD_PER_PHILOX + imad)
                / (IMAD_PER_CLK_SM * n_sm * clock))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _philox_blocks_per_sweep(spec) -> int:
    """Philox blocks one chain draws in one sweep (one per four stabilizers
    of each color)."""
    return sum(-(-sel.shape[0] // 4) for sel, _, _ in _color_tables(spec))


def _popc_per_sweep(spec, equal_betas: bool) -> int:
    """64-bit popcounts the kernels' sweep of one chain needs: per
    stabilizer and word its support spans (summed from the kernel's
    spanned-word table), two with equal betas (the error count on the
    support before and after) and four with general betas (the overlaps of
    the op's X and Z parts with the planes, and the Y count before and
    after)."""
    _, meta, offs = kernel_tables(spec)
    words = sum(len(lw.unpack_span(int(v))[0])
                for v in meta[offs["m_span"]: offs["m_span"] + spec.n_stabs])
    return (2 if equal_betas else 4) * words


def launch_line(spec, B, Nc, equal_betas) -> str:
    """The window launch at this shape: lanes per rung, threads and groups
    per block, and the warps one SM holds (launched, and the occupancy
    calculator's limit)."""
    shape, resident = launch_plan(spec, B, Nc, PROD["iters"], equal_betas)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-B // shape.groups_per_block)
    wpb = shape.threads // 32
    held = min(resident, -(-blocks // n_sm))
    return (f"L={shape.lanes} lanes per rung, {shape.warps_per_group} warp(s) "
            f"per syndrome, {shape.threads} threads and "
            f"{shape.groups_per_block} syndromes per block, {blocks} blocks, "
            f"{held * wpb} warps per SM resident (up to {resident * wpb} "
            f"by occupancy), {shape.smem} B shared memory per block")


def _nbytes(*tensors) -> int:
    return sum(t.nelement() * t.element_size() for t in tensors)


def _ladder_inputs(spec, B, Nc, seed, device):
    """Rungs with different random states (per-rung error rates in
    [0, 0.7)), flags on, nonzero tops0 / eq_count / since_burn."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, 0.7, size=(B, Nc, 1))
    s = np.where(rng.uniform(size=(B, Nc, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, Nc, spec.nq)), 0)
    flag = np.zeros((B, Nc), np.int32)
    flag[:, -1] = 1
    flag[::3, 0] = 1
    arrs = ((s * spec.valid_mask).astype(np.uint8), flag,
            rng.randint(0, 4, size=B).astype(np.int32),
            rng.randint(0, 5, size=(B, spec.n_classes)).astype(np.int32),
            rng.randint(0, 7, size=B).astype(np.int32))
    return tuple(torch.as_tensor(a, device=device) for a in arrs)


def compare_outputs(tag, kern, plain, W, both_swaps=True):
    """All outputs of the kernel and of the plain version (nine, eleven
    with traces) must be equal, and unless ``both_swaps`` is False the
    exchange must have both accepted and rejected swaps; returns the
    largest absolute difference."""
    torch.cuda.synchronize()
    check(len(kern) == len(plain), f"{tag}: {len(kern)} vs {len(plain)} outputs")
    worst = 0.0
    for name, a, b in zip(OUT_NAMES, kern, plain):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{tag}: {name} {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if name == "energies":
            # both sides form the weighted sums of integer counts times
            # f32(1/C) in f32 with the same roundings, so they must agree
            # exactly
            err = float((a - b).abs().max()) if a.numel() else 0.0
            check(err == 0.0, f"{tag}: energies differ by {err}")
        else:
            n_bad = int((a != b).sum())
            check(n_bad == 0, f"{tag}: {name} differs in {n_bad} entries")
            err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        worst = max(worst, err)
    swaps = kern[8]
    if both_swaps:
        check(bool((swaps > 0).any()) and bool((swaps < W).any()),
              f"{tag}: exchange never both accepted and rejected")
    return worst


def branch_ladder(branch, p, Nc):
    """(betas, energy weights) of a branch's ladder with bottom error rate
    ``p``: alpha (pz_tilde = p, alpha = 2) for the general sweep with the
    exact mix, biased (eta = 4) for the Metropolis mix, depolarizing for
    the equal-betas branch."""
    if branch == "general-exact":
        return beta_ladder_alpha(p, 2.0, Nc), (2.0, 2.0, 1.0)
    if branch == "general-mh":
        return beta_ladder_biased(p, 4.0, Nc), (1.0, 1.0, 1.0)
    return beta_ladder_depolarizing(p, Nc), (1.0, 1.0, 1.0)


def compare_window(family, d, Nc, B, W, iters, C, p, rng, seed,
                   branch="equal-exact", exchange="sequential", traces=False,
                   both_swaps=True, lanes=None):
    """Kernel vs plain version on the card, same inputs and draws; returns
    the largest absolute difference over all outputs.  ``lanes`` overrides
    the lanes per rung."""
    spec = get_spec(family, d)
    inputs = _ladder_inputs(spec, B, Nc, seed, "cuda")
    ladder, weights = branch_ladder(branch, p, Nc)
    betas = torch.as_tensor(ladder, dtype=torch.float32, device="cuda")
    w = np.asarray(weights, np.float32)
    top_exact, equal_betas = BRANCHES[branch]
    kw = dict(top_exact=top_exact, equal_betas=equal_betas, exchange=exchange,
              track_traces=traces)
    default_lanes = lw.lanes_per_rung
    try:
        if lanes is not None:
            lw.lanes_per_rung = lambda offs, Nc: lanes
        kern = make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, rng=rng,
                                  **kw)(*inputs, seed, betas, w)
        torch.cuda.synchronize()
    finally:
        lw.lanes_per_rung = default_lanes
    plain = ladder_window_reference(
        spec, *inputs, seed, betas, w, window=W, iters=iters, p_logical=0.5,
        tops_burn=2, energy_chunk=C, rng=rng, **kw)
    tag = (f"{family} d={d} Nc={Nc} B={B} {branch} {exchange} traces={traces} "
           f"{rng} lanes={lanes or 'default'}")
    return compare_outputs(tag, kern, plain, W, both_swaps)


def phase_parity() -> float:
    worst = 0.0
    for rng in ("philox", "zeros"):
        worst = max(worst, compare_window("toric", 5, 5, 256, 48, 2, 12, 0.15,
                                          rng, seed=1234))
    worst = max(worst, compare_window("planar", 3, 3, 256, 48, 2, 12, 0.01,
                                      "zeros", seed=99))
    # B=263 leaves the last block one syndrome short (2 per block on 132
    # SMs); every lane count; Nc=13 at L=4 makes two-warp groups with named
    # barriers
    for lanes in (None, 1, 2, 8, 32):
        worst = max(worst, compare_window("toric", 5, 5, 263, 48, 2, 12, 0.15,
                                          "philox", seed=1235, lanes=lanes))
    worst = max(worst, compare_window("toric", 5, 13, 263, 48, 2, 12, 0.15,
                                      "philox", seed=1236))
    print(f"phase 3 kernel vs plain on the card: toric d=5 Nc=5 B=256 W=48 "
          f"(philox, zeros), planar d=3 (zeros), toric d=5 B=263 (ragged last "
          f"block) at 4 (one warp per syndrome), 1, 2, 8 and 32 lanes per "
          f"rung, and Nc=13 (two warps, named barriers): all nine outputs "
          f"equal, max abs err {worst}", flush=True)
    return worst


def phase_main_path() -> int:
    spec = get_spec("toric", 5)
    B, p = 2048, 0.15
    gen = torch.Generator(device="cuda").manual_seed(2026)
    states = sample_depolarizing(gen, spec, p, (B,), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())
    cfg = PTEQConfig(max_steps=24000, **PROD)
    torch.cuda.synchronize()
    ladder_window_counts.reset()
    t0 = time.perf_counter()
    res = PTEQ(spec, states, p, cfg, seed=7, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ladder_window_counts.launches
    plain = ladder_window_counts.plain_calls
    check(launches > 0, "PTEQ never launched the kernel")
    check(plain == 0, f"PTEQ ran the plain version {plain} times")
    d = res.distribution
    check(d.shape == (B, spec.n_classes) and d.dtype == np.uint8,
          f"distribution {d.shape} {d.dtype}")
    check(bool((d.sum(axis=1) <= 100).all()), "percentages exceed 100")
    if res.converged.any():
        check(bool((d[res.converged].sum(axis=1) > 80).all()),
              "a converged row lost more than 20% to uint8 flooring")
    recovered = float(np.mean(d.argmax(axis=1) == truth))
    # the same decode with a MetricsLogger: one pteq_window record per
    # window, and the same percentages
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        logger = MetricsLogger(path)
        ladder_window_counts.reset()
        res_m, dt_m = _sync_time(lambda: PTEQ(spec, states, p, cfg, seed=7,
                                              metrics=logger, device="cuda"))
        logger.close()
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
    n_rec = sum(r["event"] == "pteq_window" for r in recs)
    check(np.array_equal(res_m.distribution, d),
          "PTEQ with metrics changed the percentages")
    check(n_rec == ladder_window_counts.launches,
          f"{n_rec} pteq_window records for {ladder_window_counts.launches} "
          f"windows")
    print(f"phase 4 PTEQ toric d=5 B={B} p={p} max_steps=24000 window=600 "
          f"iters=2 energy_chunk=12: {B / dt:.1f} syn/s ({dt:.2f} s), "
          f"converged {res.converged.mean():.3f}, windows run {launches}, "
          f"buckets {list(res.buckets)}, truth recovered {recovered:.3f}; "
          f"with metrics {B / dt_m:.1f} syn/s ({dt_m:.2f} s), {n_rec} "
          f"pteq_window records, percentages identical", flush=True)
    return launches


def phase_quality() -> None:
    spec = get_spec("toric", 5)
    z = np.load(H2H_CACHE)
    states = z["states"]
    truth = np_eq_class(spec, states)
    cfg = PTEQConfig(max_steps=48000, **PROD)
    t0 = time.perf_counter()
    ours = PTEQ(spec, states, 0.15, cfg, seed=1, device="cuda")
    dt = time.perf_counter() - t0
    d = ours.distribution.astype(float) / 100.0

    def tv(ref):
        return float(np.mean(0.5 * np.abs(d - ref / 100.0).sum(axis=1)))

    tv_a, tv_b = tv(z["ref_pteq_a"]), tv(z["ref_pteq_b"])
    arg = d.argmax(axis=1)
    agree_a = int((arg == z["ref_pteq_a"].argmax(axis=1)).sum())
    agree_b = int((arg == z["ref_pteq_b"].argmax(axis=1)).sum())
    recovered = int((arg == truth).sum())
    print(f"phase 5 h2h 64 cached syndromes (p=0.15 max_steps=48000): mean TV "
          f"to ref_pteq_a {tv_a:.4f} (bar {H2H_MAX_TV}), to ref_pteq_b "
          f"{tv_b:.4f}; argmax agreement {agree_a}/64, {agree_b}/64; truth "
          f"recovered {recovered}/64 (bar {H2H_MIN_RECOVERED}); "
          f"converged {ours.converged.mean():.3f}; {dt:.2f} s", flush=True)
    check(tv_a <= H2H_MAX_TV, f"mean TV to ref_pteq_a {tv_a:.4f} > {H2H_MAX_TV}")
    check(recovered >= H2H_MIN_RECOVERED,
          f"recovered {recovered}/64 < {H2H_MIN_RECOVERED}")
    return d


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing():
    """One window of the kernel vs one of the plain version at the main
    path's shape (B=2048, so the launch packs 16 syndromes per block); the
    two outputs must also be equal."""
    spec = get_spec("toric", 5)
    B, Nc = 2048, 5
    gen = torch.Generator(device="cuda").manual_seed(5)
    states = sample_depolarizing(gen, spec, 0.15, (B,), device="cuda")
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(beta_ladder_depolarizing(0.15, Nc),
                            dtype=torch.float32, device="cuda")
    w = np.ones(3, np.float32)
    kern = make_ladder_window(spec, Nc, PROD["window"], PROD["iters"], 0.5, 2,
                              PROD["energy_chunk"], **PROD_BRANCH)
    args = (ls.state, ls.flag, ls.tops0, eq, sb, 3, betas, w)
    kern_out = kern(*args)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: kern(*args), 5)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(ladder_window_reference(
        spec, *args, window=PROD["window"], iters=PROD["iters"], p_logical=0.5,
        tops_burn=2, energy_chunk=PROD["energy_chunk"], **PROD_BRANCH)), 1)
    err = compare_outputs("toric d=5 B=2048 W=600 philox", kern_out,
                          plain_out[0], PROD["window"])
    # the window's work: every proposal of every sweep on every rung, plus
    # the gate, logical-draw and exchange blocks of each (step, syndrome)
    W, iters = PROD["window"], PROD["iters"]
    proposals = B * Nc * W * iters * spec.n_stabs
    _, _, n_xblocks = _rng_layout(spec, Nc, iters)
    blocks = (B * Nc * W * iters * _philox_blocks_per_sweep(spec)
              + B * W * 3 * n_xblocks)
    popc = B * Nc * W * iters * _popc_per_sweep(spec, True)
    bound, bound_by = bound_ms(
        _nbytes(ls.state, ls.flag, ls.tops0, eq, sb, betas, *kern_out),
        popc, blocks)
    print(f"phase 6 one window toric d=5 B={B} Nc={Nc} W=600 iters=2 C=12: "
          f"kernel {ms:.3f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x); all nine outputs equal, max abs err {err}; "
          f"bound {bound:.4f} ms ({bound_by}; {proposals} proposals, {popc} "
          f"64-bit popcounts, {blocks} Philox blocks); launch: "
          f"{launch_line(spec, B, Nc, True)}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)




def _random_states(spec, B, seed, device="cuda"):
    """States with per-chain error rates in [0, 0.6)."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, 0.6, size=(B, 1))
    s = np.where(rng.uniform(size=(B, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, spec.nq)), 0)
    return torch.as_tensor((s * spec.valid_mask).astype(np.uint8), device=device)


def compare_sweep(family, d, B, n_sweeps, betas, equal_betas, seed):
    """K1 vs its plain version on the card, same inputs and Philox draws;
    all states must be equal.  Returns the largest absolute difference."""
    spec = get_spec(family, d)
    states = _random_states(spec, B, seed)
    b = torch.as_tensor(betas, dtype=torch.float32, device="cuda")
    kern = make_sweep(spec, n_sweeps, equal_betas)(states, seed, b)
    plain = sweep_reference(spec, states, seed, b, n_sweeps, equal_betas)
    torch.cuda.synchronize()
    tag = f"{family} d={d} B={B} equal_betas={equal_betas} betas={list(betas)}"
    n_bad = int((kern != plain).sum())
    check(n_bad == 0, f"{tag}: kernel and plain version differ in {n_bad} entries")
    check(not torch.equal(kern, states), f"{tag}: the chains never moved")
    return float((kern.int() - plain.int()).abs().max())


def compare_outputs_equal(tag, kern, plain, states):
    """The recording kernel's (states, keys, counts) against the plain
    sampler's: every entry equal and the chains moved; returns the largest
    absolute difference."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("states", "keys", "counts"), kern, plain):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{tag}: {name} {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        n_bad = int((a != b).sum())
        check(n_bad == 0, f"{tag}: {name} differs in {n_bad} entries")
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    check(not torch.equal(kern[0], states), f"{tag}: the chains never moved")
    return worst


def compare_sampler(family, d, B, steps, iters, betas, equal_betas, seed):
    """The recording kernel vs the plain sampler on the card, same inputs
    and per-step seeds."""
    spec = get_spec(family, d)
    states = _random_states(spec, B, seed)
    b = torch.as_tensor(betas, dtype=torch.float32, device="cuda")
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(seed))
    kern = make_recording_sweep(spec, steps, iters, equal_betas)(states, seeds, b)
    plain = sample_reference(spec, states, seeds, b, iters, equal_betas)
    tag = (f"sampler {family} d={d} B={B} steps={steps} iters={iters} "
           f"equal_betas={equal_betas}")
    return compare_outputs_equal(tag, kern, plain, states)


def phase_sweep_parity() -> float:
    with np.errstate(divide="ignore"):
        inf_y = betas_xyz(0.1, 0.0, 0.1)  # beta_y = inf: NaN rejects
    general = betas_xyz(0.05, 0.02, 0.1)
    cases = [
        ("toric", 5, 1000, np.full(3, 0.9), True),
        ("toric", 5, 1000, general, False),
        ("toric", 5, 1000, inf_y, False),
        ("planar", 3, 1000, np.full(3, 0.9), True),
        ("planar", 3, 1000, general, False),
        ("toric", 13, 1000, np.full(3, 0.9), True),
        ("toric", 13, 1000, general, False),
        ("toric", 19, 256, np.full(3, 0.9), True),
    ]
    worst = 0.0
    for i, (family, d, B, betas, eq) in enumerate(cases):
        worst = max(worst, compare_sweep(family, d, B, 3, betas, eq, seed=40 + i))
    # the recording mode: toric d=5 with a ragged last block (B=257: 64
    # chains per block) over two whole tiles of steps and a part, planar
    # d=3, toric d=13 (tables in shared memory), d=15 (8 words) and d=19
    # (12 words; both with their tables in device memory)
    n = 0
    for family, d, B, steps in (("toric", 5, 257, 2 * sw.TILE_STEPS + 5),
                                ("planar", 3, 257, 9), ("toric", 13, 64, 5),
                                ("toric", 15, 64, 5), ("toric", 19, 40, 4)):
        for eq in (True, False):
            for iters in (1, 3):
                worst = max(worst, compare_sampler(
                    family, d, B, steps, iters, np.full(3, 0.9) if eq else general,
                    eq, seed=60 + n))
                n += 1
    worst = max(worst, compare_sampler("toric", 5, 257, 9, 1, inf_y, False, seed=99))
    print(f"phase 7 sweep kernel vs plain on the card: toric d=5 B=1000 "
          f"(equal, general, general with beta_y=inf), planar d=3 and toric "
          f"d=13 (equal, general), toric d=19 B=256 (equal), n_sweeps=3: all "
          f"states equal; recording sampler, {n + 1} cases (toric d=5 B=257 "
          f"ragged, {2 * sw.TILE_STEPS + 5} steps; planar d=3 B=257; toric "
          f"d=13, d=15 and d=19 (12 words); equal and general betas x 1 and 3 "
          f"sweeps per step; general with beta_y=inf): states, keys and "
          f"counts equal; max abs err {worst}", flush=True)
    return worst


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loop_sampler(spec, steps, iters_per_step=1, equal_betas=False):
    """The counting sampler as the parent commit ran it, from the public
    functions: one ``make_sweep`` launch per recording step, then
    ``pack_key`` and ``count_errors_xyz`` into the stream's buffers.  The
    same contract and the same draws as ``make_recording_sweep``."""
    sweep = make_sweep(spec, iters_per_step, equal_betas)
    m = torch.as_tensor(make_hash_mults(spec).astype(np.int64), device="cuda")

    def fn(states, seeds, betas):
        R = states.shape[0]
        keys = torch.empty((R, steps, 2), dtype=torch.int64, device="cuda")
        nxyz = torch.empty((R, steps, 3), dtype=torch.int32, device="cuda")
        for t, seed in enumerate(torch.as_tensor(seeds).tolist()):
            states = sweep(states, seed, betas)
            keys[:, t] = pack_key(spec, states, m)
            nxyz[:, t] = count_errors_xyz(states)
        return states, keys, nxyz

    return fn


def _as_sampler(rec, steps):
    """A ``make_sampler``-style ``sample(states, seed, betas)`` around a
    recording function (decoders/counting.py::make_sampler's seeds)."""

    def sample(states, seed, betas):
        seeds = torch.randint(0, 2**31 - 1, (steps,),
                              generator=torch.Generator().manual_seed(int(seed)))
        lead, nq = states.shape[:-1], states.shape[-1]
        out, keys, nxyz = rec(states.reshape(-1, nq).contiguous(), seeds, betas)
        return out.reshape(states.shape), SampleStream(
            keys.reshape(lead + (steps, 2)), nxyz.reshape(lead + (steps, 3)))

    return sample


def stdc_halves(spec, states, seed, sampler=None):
    """The STDC main path's two halves, the sampling loop and the
    reduction (dedup and Z), each timed to a synchronise: (percentages,
    sampling s, reduction s).  ``sampler`` replaces the decoder's own
    (the per-step loop, for the comparison)."""
    D, steps = STDC_MAIN["droplets"], STDC_MAIN["steps"]
    fn = _get_stdc_fn(spec, D, steps, True, "off", equal_betas=True)
    seeds = _class_seeds(spec, states)
    bs, be = (torch.as_tensor(betas_depolarizing(STDC_MAIN[k]),
                              dtype=torch.float32, device="cuda")
              for k in ("p_sampling", "p"))
    if sampler is None:
        sample = lambda: fn.sample(seeds, seed, bs)
    else:
        sample = lambda: sample_classes(spec, sampler, seeds, seed, bs, D, steps, True)
    stream, t_sample = _sync_time(sample)
    (distr, _), t_reduce = _sync_time(lambda: fn.reduce(stream, be))
    return distr.cpu().numpy(), t_sample, t_reduce


def phase_stdc_main_path():
    """STDC at toric d=5, B=1024 through the sweep kernel (one recording
    launch per decode), then the same decode's two halves timed apart, and
    the decode again with the per-step loop as its sampler."""
    spec = get_spec("toric", 5)
    B, p, ps = STDC_MAIN["B"], STDC_MAIN["p"], STDC_MAIN["p_sampling"]
    D, steps = STDC_MAIN["droplets"], STDC_MAIN["steps"]
    gen = torch.Generator(device="cuda").manual_seed(2027)
    states = sample_depolarizing(gen, spec, p, (B,), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())
    # warm-up at the same shape and another seed (allocator, sort kernels,
    # first launches), not counted
    STDC(spec, states, p, ps, droplets=D, steps=steps, seed=1, device="cuda")
    torch.cuda.synchronize()
    sweep_counts.reset()
    distr, dt = _sync_time(lambda: STDC(spec, states, p, ps, droplets=D,
                                        steps=steps, seed=3, device="cuda"))
    launches, plain = sweep_counts.launches, sweep_counts.plain_calls
    check(launches == 1, f"STDC made {launches} sweep kernel launches, not 1")
    check(plain == 0, f"STDC ran the plain sampler {plain} times")
    K = spec.n_classes
    check(distr.shape == (B, K), f"distribution {distr.shape}")
    check(bool(np.isfinite(distr).all()), "non-finite percentages")
    check(bool((np.abs(distr.sum(axis=1) - 100.0) < 1e-2).all()),
          "percentages do not sum to 100")
    recovered = float(np.mean(distr.argmax(axis=1) == truth))
    d2, t_sample, t_reduce = stdc_halves(spec, states, seed=3)
    check(bool(np.allclose(d2, distr, atol=1e-4)),
          "the two halves do not reproduce the decode")
    loop = _as_sampler(loop_sampler(spec, steps, 1, True), steps)
    stdc_halves(spec, states, seed=1, sampler=loop)  # warm-up
    d3, t_loop, _ = stdc_halves(spec, states, seed=3, sampler=loop)
    n_bad = int((d3 != distr).sum())
    check(n_bad == 0, f"the decode's percentages differ from the per-step "
                      f"loop's in {n_bad} entries")
    props = B * K * D * steps * spec.n_stabs
    print(f"phase 8 STDC toric d=5 B={B} p={p} p_sampling={ps} droplets={D} "
          f"steps={steps}: {B / dt:.1f} syn/s ({dt:.3f} s), {props / dt:.4g} "
          f"proposals/s, sweep launches {launches}, truth recovered "
          f"{recovered:.3f}; split: sampling {t_sample * 1e3:.1f} ms, "
          f"reduction {t_reduce * 1e3:.1f} ms (sampling share "
          f"{t_sample / (t_sample + t_reduce):.3f}); per-step loop as the "
          f"sampler: {t_loop * 1e3:.1f} ms, percentages equal to the "
          f"decode's", flush=True)
    return launches


def phase_counting_quality(pteq_distr) -> None:
    spec = get_spec("toric", 5)
    z = np.load(H2H_CACHE)
    truth = np_eq_class(spec, z["states"])
    kw = dict(H2H_COUNTING)
    p, ps = kw.pop("p"), kw.pop("p_sampling")
    (stdc, strc), dt = _sync_time(lambda: (
        STDC(spec, z["warm"], p, ps, device="cuda", **kw),
        STRC(spec, z["warm"], p, ps, device="cuda", **kw)))

    def tv(a, b):
        return float(np.mean(0.5 * np.abs(a / 100.0 - b / 100.0).sum(axis=1)))

    parts, fails = [], []
    for name, d, ref in (("STDC", stdc, z["ref_stdc"]), ("STRC", strc, z["ref_strc"])):
        t = tv(d, ref)
        agree = int((d.argmax(axis=1) == ref.argmax(axis=1)).sum())
        rec = int((d.argmax(axis=1) == truth).sum())
        parts.append(f"{name}: mean TV to ref {t:.4f} (bar {H2H_COUNTING_MAX_TV}), "
                     f"argmax agreement {agree}/64, truth recovered {rec}/64 "
                     f"(bar {H2H_COUNTING_MIN_RECOVERED})")
        if t > H2H_COUNTING_MAX_TV:
            fails.append(f"{name} mean TV to ref {t:.4f} > {H2H_COUNTING_MAX_TV}")
        if rec < H2H_COUNTING_MIN_RECOVERED:
            fails.append(f"{name} recovered {rec}/64 < {H2H_COUNTING_MIN_RECOVERED}")
    t_pteq = tv(stdc, pteq_distr * 100.0)
    agree_pteq = int((stdc.argmax(axis=1) == pteq_distr.argmax(axis=1)).sum())
    print(f"phase 9 h2h 64 cached syndromes, warm starts, p={p} "
          f"p_sampling={ps} droplets={kw['droplets']} steps={kw['steps']}: "
          f"{'; '.join(parts)}; STDC vs port PTEQ: mean TV {t_pteq:.4f} "
          f"(bar {H2H_STDC_PTEQ_MAX_TV}), argmax agreement {agree_pteq}/64; "
          f"{dt:.2f} s for both", flush=True)
    if t_pteq > H2H_STDC_PTEQ_MAX_TV:
        fails.append(f"TV STDC vs PTEQ {t_pteq:.4f} > {H2H_STDC_PTEQ_MAX_TV}")
    check(not fails, "; ".join(fails))


def sampler_launch_line(spec, R, equal_betas) -> str:
    """The sweep kernel's launch at this shape: lanes per chain, chains per
    warp and block, and the warps one SM holds (launched, and the occupancy
    calculator's limit)."""
    plan, resident = sw.launch_plan(spec, R, True, equal_betas)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-R // plan.chains_per_block)
    wpb = sw.SWEEP_THREADS // 32
    held = min(resident, -(-blocks // n_sm))
    return (f"L={plan.lanes} lanes per chain, {plan.chains_per_warp} chains per "
            f"warp, {plan.chains_per_block} per block of {sw.SWEEP_THREADS} "
            f"threads, {blocks} blocks, {held * wpb} warps per SM resident (up "
            f"to {resident * wpb} by occupancy), tables in "
            f"{'shared' if plan.tab_in_smem else 'device'} memory, {plan.smem} B "
            f"shared memory per block")


def sampler_bound(spec, R, steps, iters, equal_betas, n_bytes):
    """(least ms, bound_by) of the recording sampler: ``bound_ms`` of the
    bytes moved (states in and out, seeds, the stream written), the
    popcounts (per proposal two per spanned word with equal betas, four
    with general betas; three per word of the plane per step for the
    counts), the Philox blocks and the hash's two multiplies per qubit and
    step."""
    nw = kernel_words(spec.nq)
    popc = R * steps * (iters * _popc_per_sweep(spec, equal_betas) + 3 * nw)
    blocks = R * steps * iters * _philox_blocks_per_sweep(spec)
    return bound_ms(n_bytes, popc, blocks, imad=R * steps * 2 * spec.nq)


def phase_sweep_timing():
    """At the STDC main path's shape (1024 syndromes x 16 classes x 4
    droplets = 65,536 chains of toric d=5, equal betas): one launch of the
    sweep kernel with one sweep and with 100 sweeps, each against the
    plain version; then the recording sampler's one launch for the whole
    450-step loop against the per-step loop it replaces (the parent
    commit's path) and against the plain sampler.  Outputs must be
    equal."""
    spec = get_spec("toric", 5)
    R = STDC_MAIN["B"] * spec.n_classes * STDC_MAIN["droplets"]
    states = _random_states(spec, R, seed=9)
    b = torch.as_tensor(betas_depolarizing(STDC_MAIN["p_sampling"]),
                        dtype=torch.float32, device="cuda")
    res = {}
    for n_sweeps, reps in ((1, 200), (100, 10)):
        fn = make_sweep(spec, n_sweeps, equal_betas=True)
        out = fn(states, 5, b)  # warm-up, kept for the comparison
        ms = _time_ms(lambda: fn(states, 5, b), reps)
        plain_out = []
        plain_ms = _time_ms(lambda: plain_out.append(sweep_reference(
            spec, states, 5, b, n_sweeps, equal_betas=True)), 1)
        n_bad = int((out != plain_out[0]).sum())
        check(n_bad == 0, f"n_sweeps={n_sweeps}: kernel and plain version "
                          f"differ in {n_bad} entries")
        err = float((out.int() - plain_out[0].int()).abs().max())
        bound, bound_by = bound_ms(
            _nbytes(states, out, b),
            R * n_sweeps * _popc_per_sweep(spec, True),
            R * n_sweeps * _philox_blocks_per_sweep(spec))
        res[n_sweeps] = dict(ms=ms, plain_ms=plain_ms, err=err,
                             bound_ms=bound, bound_by=bound_by)
    print("phase 10 sweep kernel, toric d=5, 65,536 chains, equal betas: "
          + "; ".join(
              f"n_sweeps={n}: kernel {r['ms']:.4f} ms, plain version "
              f"{r['plain_ms']:.1f} ms ({r['plain_ms'] / r['ms']:.1f}x), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
              for n, r in res.items())
          + "; all states equal", flush=True)

    steps = STDC_MAIN["steps"]
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(8))
    rec = make_recording_sweep(spec, steps, 1, equal_betas=True)
    loop = loop_sampler(spec, steps, 1, equal_betas=True)
    kern = rec(states, seeds, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: rec(states, seeds, b), 5)
    loop(states, seeds, b)  # warm-up
    loop_out = []
    loop_ms = _time_ms(lambda: loop_out.append(loop(states, seeds, b)), 1)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sample_reference(
        spec, states, seeds, b, 1, equal_betas=True)), 1)
    err = max(compare_outputs_equal("sampler vs plain, 65,536 chains", kern,
                                    plain_out[0], states),
              compare_outputs_equal("sampler vs per-step loop, 65,536 chains",
                                    kern, loop_out[0], states))
    n_bytes = _nbytes(states, seeds, *kern)
    bound, bound_by = sampler_bound(spec, R, steps, 1, True, n_bytes)
    stream_ms = _nbytes(*kern[1:]) / HBM_BYTES_PER_S * 1e3
    print(f"phase 10 recording sampler, toric d=5, 65,536 chains, {steps} steps "
          f"of one sweep, equal betas, one launch: kernel {ms:.3f} ms, per-step "
          f"loop {loop_ms:.1f} ms ({loop_ms / ms:.1f}x), plain sampler "
          f"{plain_ms:.1f} ms ({plain_ms / ms:.1f}x); states, keys and counts "
          f"equal to both; bound {bound:.4f} ms ({bound_by}; the stream's "
          f"{_nbytes(*kern[1:]) / 1e6:.1f} MB alone {stream_ms:.4f} ms); "
          f"launch: {sampler_launch_line(spec, R, True)}", flush=True)
    res["sampler"] = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, err=err,
                          bound_ms=bound, bound_by=bound_by)
    return res


COMBOS = [(b, e) for b in BRANCHES for e in ("sequential", "even_odd")]


def phase_branch_parity() -> float:
    """K2's other branches, kernel vs plain version on the card: every
    combination of sweep form and mix kind with both exchange schedules,
    at xzzx d=5 (1 word per plane; Philox and zero draws), xzzx d=13 (3),
    toric d=13 (6) and toric d=19 (12 words; tables in device memory),
    traces on in half the cases of each."""
    worst, n = 0.0, 0
    for i, (branch, exchange) in enumerate(COMBOS):
        for rng in ("philox", "zeros"):
            worst = max(worst, compare_window(
                "xzzx", 5, 5, 256, 48, 2, 12, 0.15, rng, 300 + i, branch,
                exchange, traces=i % 2 == 0, both_swaps=rng == "philox"))
            n += 1
    for family, d, B, W in (("xzzx", 13, 256, 24), ("toric", 13, 128, 12),
                            ("toric", 19, 64, 8)):
        for i, (branch, exchange) in enumerate(COMBOS):
            worst = max(worst, compare_window(
                family, d, d, B, W, 2, 4, 0.15, "philox", 400 + i, branch,
                exchange, traces=i % 2 == 0))
            n += 1
    # xzzx d=13's four-warp groups with a ragged last block (B=263: 2 per
    # block), and toric d=19 with 25 rungs, whose tables leave no room for
    # the group and are read from device memory
    for i, (branch, exchange) in enumerate(COMBOS[:2]):
        worst = max(worst, compare_window(
            "xzzx", 13, 13, 263, 24, 2, 4, 0.15, "philox", 510 + i, branch,
            exchange, traces=i % 2 == 1))
        worst = max(worst, compare_window(
            "toric", 19, 25, 16, 8, 2, 4, 0.15, "philox", 520 + i, branch,
            exchange, traces=i % 2 == 0))
        n += 2
    print(f"phase 11 window kernel vs plain, other branches: {n} cases "
          f"(general/exact, general/Metropolis and equal/exact mix x "
          f"sequential and even_odd exchange; xzzx d=5 Philox and zeros, "
          f"xzzx d=13, toric d=13, toric d=19 Philox; words per plane "
          f"1/3/6/12; xzzx d=13 B=263 ragged; toric d=19 Nc=25, its tables "
          f"in device memory): all outputs equal, traces included, max abs "
          f"err {worst}", flush=True)
    return worst


def phase_biased_main_path():
    """PTEQ_alpha at one cell of the XZZX threshold study through the
    kernel: biased noise (p, eta) sampled on the card and decoded with its
    alpha equivalent (examples/threshold_fit_biased.py:60-84)."""
    m = BIASED_MAIN
    spec = get_spec("xzzx", m["d"])
    px, py, pz = xyz_probs_from_biased(m["p"], m["eta"])
    pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
    cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
    gen = torch.Generator(device="cuda").manual_seed(2028)
    fails = conv = 0
    dt = 0.0
    per_call = []  # windows each call ran; the cap is max_steps // window
    torch.cuda.synchronize()
    ladder_window_counts.reset()
    for call in range(m["calls"]):
        before = ladder_window_counts.launches
        states = sample_xyz(gen, spec, px, py, pz, (m["B"],), device="cuda")
        truth = np_eq_class(spec, states.cpu().numpy())
        res, t = _sync_time(lambda: PTEQ_alpha(
            spec, states, pz_tilde, alpha, cfg, seed=call + 1, device="cuda"))
        dt += t
        per_call.append(ladder_window_counts.launches - before)
        d = res.distribution
        check(d.shape == (m["B"], spec.n_classes) and d.dtype == np.uint8,
              f"distribution {d.shape} {d.dtype}")
        check(bool((d.sum(axis=1) <= 100).all()), "percentages exceed 100")
        fails += int((d.argmax(axis=1) != truth).sum())
        conv += int(res.converged.sum())
    launches = ladder_window_counts.launches
    plain = ladder_window_counts.plain_calls
    check(launches > 0, "PTEQ_alpha never launched the kernel")
    check(plain == 0, f"PTEQ_alpha ran the plain version {plain} times")
    n = m["B"] * m["calls"]
    failure, converged = fails / n, conv / n
    cap = m["max_steps"] // PROD["window"]
    print(f"phase 12 PTEQ_alpha xzzx d={m['d']} Nc={m['d']} eta={m['eta']} "
          f"p={m['p']} (pz_tilde={pz_tilde:.6f}, alpha={alpha:.6f}) "
          f"max_steps={m['max_steps']} window=600 iters=2 energy_chunk=12, "
          f"{m['calls']} calls of B={m['B']}: {n / dt:.1f} syn/s ({dt:.2f} s), "
          f"failure {failure:.4f} (JAX study {BIASED_REF_FAILURE}, bar "
          f"+-{BIASED_MAX_FAILURE_GAP}), converged {converged:.4f} (bar "
          f"{BIASED_MIN_CONVERGED}), windows run {launches} (per call "
          f"{per_call}; {sum(w == cap for w in per_call)} of {m['calls']} "
          f"calls at the cap of {cap})", flush=True)
    check(abs(failure - BIASED_REF_FAILURE) <= BIASED_MAX_FAILURE_GAP,
          f"failure {failure:.4f} not within {BIASED_MAX_FAILURE_GAP} of "
          f"{BIASED_REF_FAILURE}")
    check(converged >= BIASED_MIN_CONVERGED,
          f"converged {converged:.4f} < {BIASED_MIN_CONVERGED}")
    return launches


def _xyz_state(spec, px, py, pz, seed):
    """One state from the port's X/Y/Z sampler on a seeded CPU generator
    (the states of tests/test_torch_pteq_biased.py)."""
    return sample_xyz(torch.Generator().manual_seed(seed), spec, px, py, pz).numpy()


def phase_exact_d3():
    """Biased, alpha and even_odd PTEQ on a replicated d=3 syndrome (B=64)
    against the exact posterior, the shortest-chain argmax at xzzx d=3,
    and shortest tracking at xzzx d=5 B=512 with the time of its update."""
    p, eta = 0.12, 4.0
    bxyz = xyz_probs_from_biased(p, eta)
    alpha, pz_tilde = 2.0, 0.15
    ab = -np.log(pz_tilde) * np.array([alpha, alpha, 1.0])
    p3 = (0.1 / 3,) * 3
    xzzx, toric = get_spec("xzzx", 3), get_spec("toric", 3)
    cfg = PTEQConfig(**EXACT_CFG)
    cases = [
        ("PTEQ_biased", xzzx, _xyz_state(xzzx, *bxyz, seed=4), betas_xyz(*bxyz),
         lambda sp, st: PTEQ_biased(sp, st, p, eta, cfg, seed=6, device="cuda")),
        ("PTEQ_alpha", xzzx, _xyz_state(xzzx, *p3, seed=3), ab,
         lambda sp, st: PTEQ_alpha(sp, st, pz_tilde, alpha, cfg, seed=4,
                                   device="cuda")),
        ("PTEQ even_odd", toric, _xyz_state(toric, *p3, seed=2),
         betas_depolarizing(0.1),
         lambda sp, st: PTEQ(sp, st, 0.1, dataclasses.replace(
             cfg, exchange="even_odd"), seed=2, device="cuda")),
    ]
    parts, fails = [], []
    for name, spec, s0, betas, run in cases:
        exact = exact_mld(spec, s0[None], betas)[0]
        res = run(spec, np.tile(s0[None], (64, 1)))
        mean = res.distribution.mean(axis=0) / 100.0
        tv = float(0.5 * np.abs(mean - exact).sum())
        same = int(mean.argmax()) == int(exact.argmax())
        parts.append(f"{name} TV {tv:.4f} argmax {'equal' if same else 'DIFFERS'} "
                     f"(exact max {exact.max():.3f})")
        if tv >= EXACT_MAX_TV or not same:
            fails.append(f"{name}: TV {tv:.4f}, argmax equal {same}")
    s0 = _xyz_state(xzzx, *p3, seed=0)
    exact = exact_mld(xzzx, s0[None], ab)[0]
    res = PTEQ_alpha_with_shortest(
        xzzx, s0[None], pz_tilde, alpha,
        PTEQConfig(max_steps=3000, window=200, TOPS=10, SEQ=2, energy_chunk=4),
        seed=1, device="cuda")
    same = int(res.shortest_boltzmann[0].argmax()) == int(exact.argmax())
    parts.append(f"PTEQ_alpha_with_shortest argmax {'equal' if same else 'DIFFERS'}")
    if not same:
        fails.append("shortest-chain argmax differs from the exact one")
    sh_res = _shortest_at_d5(alpha, pz_tilde)
    print(f"phase 13 d=3 exact checks (B=64, max_steps=24000, window=400, "
          f"TOPS=30, SEQ=4; bar TV < {EXACT_MAX_TV}, same argmax): "
          f"{'; '.join(parts)}; PTEQ_alpha_with_shortest xzzx d=5 B=512 "
          f"max_steps=6000: {sh_res}", flush=True)
    check(not fails, "; ".join(fails))


def _shortest_at_d5(alpha, pz_tilde):
    """PTEQ_alpha_with_shortest at xzzx d=5 B=512 (sanity of the three
    distributions, syn/s, windows run), and over one 600-step window of
    that shape the ms of the trace-mode window kernel and of the
    shortest-state update with every step burned."""
    spec = get_spec("xzzx", 5)
    B, Nc, W = 512, 5, 600
    gen = torch.Generator(device="cuda").manual_seed(2029)
    states = sample_depolarizing(gen, spec, 0.1, (B,), device="cuda")
    ladder_window_counts.reset()
    res, dt = _sync_time(lambda: PTEQ_alpha_with_shortest(
        spec, states, pz_tilde, alpha,
        PTEQConfig(max_steps=6000, **PROD), seed=3, device="cuda"))
    windows = ladder_window_counts.launches
    for name in ("shortest_boltzmann", "shortest_counts"):
        d = getattr(res, name)
        check(d.shape == (B, spec.n_classes) and bool(np.isfinite(d).all()),
              f"{name} {d.shape} not finite")
        check(bool((np.abs(d.sum(axis=1) - 100.0) < 1e-6).all()),
              f"{name} rows do not sum to 100")
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(beta_ladder_alpha(pz_tilde, alpha, Nc),
                            dtype=torch.float32, device="cuda")
    w = np.array([alpha, alpha, 1.0], np.float32)
    window = make_ladder_window(spec, Nc, W, 2, 0.5, 2, 1, top_exact=True,
                                equal_betas=False, track_traces=True)
    args = (ls.state, ls.flag, ls.tops0, eq, sb, 5, betas, w)
    out = window(*args)
    window_ms = _time_ms(lambda: window(*args), 3)
    burn_any = torch.ones((B,), dtype=torch.bool, device="cuda")
    burn_first = torch.zeros((B,), dtype=torch.int32, device="cuda")
    sh0 = init_shortest(B, spec.n_classes, 128, "cuda")
    scan = lambda: _shortest_scan(sh0, out[9], out[5], out[10], burn_any, burn_first)
    scan()
    update_ms = _time_ms(scan, 3)
    return (f"{B / dt:.1f} syn/s ({dt * 1e3:.1f} ms, {windows} windows), "
            f"converged {res.converged.mean():.3f}, overflow rows "
            f"{int(res.shortest_overflow.any(axis=1).sum())}; per 600-step "
            f"window: trace-mode window kernel {window_ms:.3f} ms, shortest "
            f"update {update_ms:.1f} ms (the update at most "
            f"{windows * update_ms / (dt * 1e3):.3f} of the decode)")


def phase_general_timing():
    """One window of the general branch at the biased path's shape (xzzx
    d=13, Nc=13, B=512, W=600, alpha ladder, exact mix) on the kernel
    against one of the plain version on the same inputs; the two outputs
    must also be equal."""
    m = BIASED_MAIN
    spec = get_spec("xzzx", m["d"])
    B, Nc, W, iters, C = m["B"], m["d"], PROD["window"], PROD["iters"], PROD["energy_chunk"]
    px, py, pz = xyz_probs_from_biased(m["p"], m["eta"])
    pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    states = sample_xyz(gen, spec, px, py, pz, (B,), device="cuda")
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(beta_ladder_alpha(pz_tilde, alpha, Nc),
                            dtype=torch.float32, device="cuda")
    w = np.array([alpha, alpha, 1.0], np.float32)
    branch = dict(top_exact=True, equal_betas=False)
    args = (ls.state, ls.flag, ls.tops0, eq, sb, 3, betas, w)
    kern = make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, **branch)
    kern_out = kern(*args)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: kern(*args), 3)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(ladder_window_reference(
        spec, *args, window=W, iters=iters, p_logical=0.5, tops_burn=2,
        energy_chunk=C, **branch)), 1)
    err = compare_outputs(f"xzzx d=13 B={B} W={W} general philox", kern_out,
                          plain_out[0], W)
    nw = kernel_words(spec.nq)
    proposals = B * Nc * W * iters * spec.n_stabs
    _, _, n_xblocks = _rng_layout(spec, Nc, iters)
    blocks = (B * Nc * W * iters * _philox_blocks_per_sweep(spec)
              + B * W * (_N_EXTRA_USES - 1) * n_xblocks)
    popc = B * Nc * W * iters * _popc_per_sweep(spec, False)
    n_bytes = _nbytes(*args[:5], betas, *kern_out)
    bound, bound_by = bound_ms(n_bytes, popc, blocks)
    # the count before the kernel took only spanned words: 6 popcounts on
    # every word of the plane
    dense, _ = bound_ms(n_bytes, 6 * nw * proposals, blocks)
    print(f"phase 14 one general-branch window xzzx d={m['d']} B={B} Nc={Nc} "
          f"W={W} iters={iters} C={C} (alpha ladder, exact mix): kernel "
          f"{ms:.3f} ms, plain version {plain_ms:.1f} ms ({plain_ms / ms:.1f}x); "
          f"all outputs equal, max abs err {err}; bound {bound:.4f} ms "
          f"({bound_by}; {proposals} proposals, {popc} 64-bit popcounts on "
          f"the spanned words, {blocks} Philox blocks; {dense:.4f} ms counting "
          f"6 popcounts on each of {nw} words); launch: "
          f"{launch_line(spec, B, Nc, False)}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)


def _peak(fn):
    """(fn(), seconds, peak device bytes allocated during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, dt = _sync_time(fn)
    return out, dt, torch.cuda.max_memory_allocated()


def phase_stream_parity():
    """STDC, STRC and STDC with conv_mult=2.0 at the STDC main path's shape
    (toric d=5, B=1024, droplets=4, steps=450), streamed in 8 windows of 64
    steps against the materialised decode of the same seed: the same
    samples, so STDC's percentages agree to float32 rounding (and the same
    argmax wherever the top two classes are apart), STRC's are equal, and
    conv_mult's agree on every cell whose droplets' key buffers never
    overflowed.  One sweep-kernel launch per window, no plain call."""
    spec = get_spec("toric", 5)
    B, p, ps = STDC_MAIN["B"], STDC_MAIN["p"], STDC_MAIN["p_sampling"]
    D, steps = STDC_MAIN["droplets"], STDC_MAIN["steps"]
    W, cap, tol = (STREAM_CHECK[k] for k in ("window", "capacity", "max_diff"))
    n_win = -(-steps // W)
    gen = torch.Generator(device="cuda").manual_seed(2027)
    states = sample_depolarizing(gen, spec, p, (B,), device="cuda")
    kw = dict(droplets=D, steps=steps, device="cuda")
    st_kw = dict(stream=True, stream_window=W, stream_capacity=cap)
    # warm-up of both paths (allocator, sorts), not counted
    STDC(spec, states, p, ps, seed=1, stream=False, **kw)
    STDC(spec, states, p, ps, seed=1, **st_kw, **kw)
    lines = []
    mat, t_mat, m_mat = _peak(lambda: STDC(spec, states, p, ps, seed=3,
                                           stream=False, **kw))
    sweep_counts.reset()
    streamed, t_str, m_str = _peak(lambda: STDC(spec, states, p, ps, seed=3,
                                                **st_kw, **kw))
    launches, plain = sweep_counts.launches, sweep_counts.plain_calls
    check(launches == n_win, f"streamed STDC made {launches} sweep launches, "
                             f"not {n_win}")
    check(plain == 0, f"streamed STDC ran the plain sampler {plain} times")
    diff = float(np.abs(streamed - mat).max())
    check(diff <= tol, f"streamed STDC differs from materialised by {diff}")
    top2 = np.sort(mat, axis=1)[:, -2:]
    apart = (top2[:, 1] - top2[:, 0]) > 2 * tol
    n_arg = int((mat.argmax(1) != streamed.argmax(1))[apart].sum())
    check(n_arg == 0, f"streamed STDC changes the argmax of {n_arg} rows")
    lines.append(f"STDC max |diff| {diff:.3g} (<= {tol}), argmax equal on "
                 f"{int(apart.sum())} rows ({B - int(apart.sum())} near-ties), "
                 f"{launches} sweep launches, streamed {B / t_str:.1f} syn/s "
                 f"peak {m_str / 1e9:.3f} GB against materialised "
                 f"{B / t_mat:.1f} syn/s peak {m_mat / 1e9:.3f} GB")

    STRC(spec, states, p, ps, seed=1, **st_kw, **kw)  # warm-up
    smat, t_smat, m_smat = _peak(lambda: STRC(spec, states, p, ps, seed=3,
                                              stream=False, **kw))
    sweep_counts.reset()
    sstr, t_sstr, m_sstr = _peak(lambda: STRC(spec, states, p, ps, seed=3,
                                              **st_kw, **kw))
    check(sweep_counts.launches == n_win and sweep_counts.plain_calls == 0,
          f"streamed STRC: {sweep_counts.launches} launches, "
          f"{sweep_counts.plain_calls} plain calls")
    n_bad = int((sstr != smat).sum())
    check(n_bad == 0, f"streamed STRC differs from materialised in {n_bad} "
                      f"entries")
    lines.append(f"STRC equal, streamed {B / t_sstr:.1f} syn/s peak "
                 f"{m_sstr / 1e9:.3f} GB against materialised "
                 f"{B / t_smat:.1f} syn/s peak {m_smat / 1e9:.3f} GB")

    cm = STREAM_CHECK["conv_mult"]
    seeds = _class_seeds(spec, states)
    bs, be = (torch.as_tensor(betas_depolarizing(x), dtype=torch.float32,
                              device="cuda") for x in (ps, p))
    f_mat = _get_stdc_fn(spec, D, steps, True, "off", cm, equal_betas=True)
    f_str = _get_stdc_stream_fn(spec, D, steps, True, "off", cm, "auto",
                                False, True, cap, W)
    f_mat(seeds, 1, bs, be)  # warm-up
    f_str(seeds, 1, bs, be)
    (cmat, _), t_cmat, m_cmat = _peak(lambda: f_mat(seeds, 3, bs, be))
    out, t_cstr, m_cstr = _peak(lambda: f_str(seeds, 3, bs, be))
    kovf = out[-1].cpu().numpy()
    # a cell's kovf moves every percentage of its syndrome (the softmax
    # over classes), so compare the syndromes without any
    ok = ~kovf.any(axis=1)
    cdiff = float(np.abs(out[0].cpu().numpy() - cmat.cpu().numpy())[ok].max())
    check(ok.any() and cdiff <= tol,
          f"streamed conv_mult STDC differs by {cdiff} on rows without kovf")
    lines.append(f"STDC conv_mult={cm} max |diff| {cdiff:.3g} on the "
                 f"{int(ok.sum())} rows without kovf (kovf in "
                 f"{int(kovf.sum())} of {kovf.size} cells), streamed "
                 f"{B / t_cstr:.1f} syn/s peak {m_cstr / 1e9:.3f} GB against "
                 f"materialised {B / t_cmat:.1f} syn/s peak "
                 f"{m_cmat / 1e9:.3f} GB")
    print(f"phase 15 streamed vs materialised, toric d=5 B={B} p={p} "
          f"p_sampling={ps} droplets={D} steps={steps}, {n_win} windows of "
          f"{W} (last {steps - (n_win - 1) * W}), capacity {cap}: "
          + "; ".join(lines), flush=True)


def _window_launch(spec, R, W, ps):
    """One stream window's sweep-kernel launch at the reference budget's
    shape (R chains, W recording steps, equal betas) against the plain
    sampler on the same inputs: outputs equal; (ms, plain ms, err, bound,
    bound_by)."""
    states = _random_states(spec, R, seed=10)
    b = torch.as_tensor(betas_depolarizing(ps), dtype=torch.float32,
                        device="cuda")
    seeds = torch.randint(0, 2**31 - 1, (W,),
                          generator=torch.Generator().manual_seed(12))
    rec = make_recording_sweep(spec, W, 1, equal_betas=True)
    kern = rec(states, seeds, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: rec(states, seeds, b), 3)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sample_reference(
        spec, states, seeds, b, 1, equal_betas=True)), 1)
    err = compare_outputs_equal(f"window launch, {R} chains x {W} steps",
                                kern, plain_out[0], states)
    bound, bound_by = sampler_bound(spec, R, W, 1, True,
                                    _nbytes(states, seeds, *kern))
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)


def phase_stream_main_path():
    """STDC at the reference's default budget (decoders.py:268): toric d=9,
    B=1024 syndromes x 16 classes x 10 droplets = 163,840 chains, 20,000
    steps, stream="auto" (which must pick the streaming path: the
    materialised stream would be 91.8 GB).  49 windows of 409 steps, each
    one sweep-kernel launch; prints syn/s, the device ms of the sampling
    launches against the merges, peak memory, overflowed rows with the
    worst relative Z-deficit bound, and the truth recovery.  Then the same
    budget with conv_mult=2.0 at B=128, and one window launch against the
    plain sampler."""
    m = STREAM_MAIN
    spec = get_spec("toric", m["d"])
    K = spec.n_classes
    B, p, ps, D, steps = (m[k] for k in ("B", "p", "p_sampling", "droplets",
                                         "steps"))
    R = B * K * D
    W = _pick_stream_window(D, steps)
    n_win = -(-steps // W)
    check(should_stream("auto", B * K, D, steps),
          "stream='auto' does not resolve to streaming at this budget")
    gen = torch.Generator(device="cuda").manual_seed(2028)
    states = sample_depolarizing(gen, spec, p, (B,), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())
    kw = dict(droplets=D, steps=steps, device="cuda")
    # warm-up at B=16 and the same budget (below 1 GiB, so forced)
    STDC(spec, states[: m["warm_B"]], p, ps, seed=1, stream=True, **kw)
    seen = {}
    warn = stdc_mod.warn_stream_overflow

    def record(overflow, max_kept, min_rank, n_samples, *args, **kwargs):
        seen.update(overflow=overflow, bound=stream_deficit_bound(
            overflow, max_kept, min_rank, n_samples))
        return warn(overflow, max_kept, min_rank, n_samples, *args, **kwargs)

    stdc_mod.warn_stream_overflow = record
    stream_timing.enabled = True
    try:
        stream_timing.reset()
        sweep_counts.reset()
        distr, dt, peak = _peak(lambda: STDC(spec, states, p, ps, seed=3, **kw))
        launches, plain = sweep_counts.launches, sweep_counts.plain_calls
        windows = stream_timing.windows
        split = stream_timing.ms()
        main_seen = dict(seen)
        # conv_mult at B=128 of the same budget (warm-up: two windows)
        Bc = m["conv_mult_B"]
        STDC(spec, states[: m["warm_B"]], p, ps, seed=1, stream=True,
             conv_mult=2.0, droplets=D, steps=2 * W, device="cuda")
        stream_timing.reset()
        _, dt_c, peak_c = _peak(lambda: STDC(spec, states[:Bc], p, ps, seed=3,
                                             conv_mult=2.0, **kw))
        split_c = stream_timing.ms()
        windows_c = stream_timing.windows
        # what the capacity truncates: the B=128 decode again at 8 times
        # the default capacity, same seed and samples
        stream_timing.enabled = False
        small = STDC(spec, states[:Bc], p, ps, seed=3, **kw)
        big = STDC(spec, states[:Bc], p, ps, seed=3,
                   stream_capacity=m["big_capacity"], **kw)
    finally:
        stdc_mod.warn_stream_overflow = warn
        stream_timing.enabled = False
    check(launches == n_win, f"{launches} sweep launches, not {n_win}")
    check(windows == n_win, f"{windows} windows, not {n_win}")
    check(plain == 0, f"the plain sampler ran {plain} times")
    check(distr.shape == (B, K) and bool(np.isfinite(distr).all()),
          f"percentages {distr.shape} not finite")
    check(bool((np.abs(distr.sum(axis=1) - 100.0) < 1e-2).all()),
          "percentages do not sum to 100")
    check(peak < m["max_peak_gb"] * 1e9,
          f"peak memory {peak / 1e9:.2f} GB >= {m['max_peak_gb']} GB")
    materialised = B * K * D * steps * PORT_BYTES_PER_SAMPLE
    recovered = float(np.mean(distr.argmax(axis=1) == truth))
    n_ovf = int(main_seen["overflow"].sum())
    worst = float(main_seen["bound"].max())
    n_bad = int((main_seen["bound"] > 1e-9).sum())
    cap_diff = float(np.abs(small - big).max())
    cap_arg = int((small.argmax(1) != big.argmax(1)).sum())
    cap_rec = float(np.mean(big.argmax(axis=1) == truth[:Bc]))
    win = _window_launch(spec, R, W, ps)
    print(f"phase 16 STDC at the reference budget, toric d={m['d']} B={B} "
          f"p={p} p_sampling={ps} droplets={D} steps={steps}, stream='auto' "
          f"(streams: {STREAM_BYTES_PER_SAMPLE}-byte model above 1 GiB): "
          f"{B / dt:.2f} syn/s ({dt:.2f} s), {windows} windows of {W}, "
          f"{launches} sweep launches; device ms: sampling "
          f"{split.get('sample', 0.0):.1f}, merge {split.get('merge', 0.0):.1f} "
          f"(per window {split.get('sample', 0.0) / windows:.2f} and "
          f"{split.get('merge', 0.0) / windows:.2f}); peak "
          f"{peak / 1e9:.2f} GB (materialised stream alone "
          f"{materialised / 1e9:.1f} GB); overflowed (syndrome, class) "
          f"rows {n_ovf} of {B * K}, worst relative Z-deficit bound "
          f"{worst:.3g} ({n_bad} rows above the warning's 1e-9); truth "
          f"recovered {recovered:.3f}; conv_mult=2.0 at B={Bc}: "
          f"{Bc / dt_c:.2f} syn/s ({dt_c:.2f} s), peak {peak_c / 1e9:.2f} GB, "
          f"per window: sampling {split_c.get('sample', 0.0) / windows_c:.2f} "
          f"ms, conv_mult automaton "
          f"{split_c.get('conv_mult', 0.0) / windows_c:.2f} ms, merge "
          f"{split_c.get('merge', 0.0) / windows_c:.2f} ms; capacity 4096 "
          f"against {m['big_capacity']} at B={Bc}: max |diff| {cap_diff:.3g} "
          f"percentage points, argmax changed in {cap_arg} rows, truth "
          f"recovered {cap_rec:.3f} at {m['big_capacity']}; one window launch "
          f"({R} chains x {W} steps): kernel {win['ms']:.3f} ms, plain sampler "
          f"{win['plain_ms']:.1f} ms, states, keys and counts equal, bound "
          f"{win['bound_ms']:.4f} ms ({win['bound_by']}); launch: "
          f"{sampler_launch_line(spec, R, True)}", flush=True)
    win["launches"] = launches
    return win


# ---------------------------------------------------------------------------
# The PT ladder step on K1 with a row of betas per chain (PTDC, PTRC,
# single_temp, the unfused engines)
# ---------------------------------------------------------------------------


def _chain_rows(R, Nc, p, seed):
    """(R, 3) f32 betas on the card: the rows of a depolarizing ladder at
    ``p`` with Nc rungs, one picked at random for each chain."""
    rng = np.random.RandomState(seed)
    ladder = beta_ladder_depolarizing(p, Nc).astype(np.float32)
    return torch.as_tensor(ladder[rng.randint(0, Nc, R)], device="cuda")


def compare_per_chain(family, d, R, steps, iters, seed):
    """K1's general branch at a row of betas per chain against its plain
    versions on the same inputs and draws: the recording sampler (states,
    keys, counts) and the sweep (states), all equal; and with every chain
    on the first chain's row, the per-chain launch equals the shared-row
    launch.  Returns the largest absolute difference."""
    spec = get_spec(family, d)
    states = _random_states(spec, R, seed)
    b = _chain_rows(R, 5, 0.1, seed)
    seeds = torch.randint(0, 2**62, (steps,),
                          generator=torch.Generator().manual_seed(seed))
    rec = make_recording_sweep(spec, steps, iters, equal_betas=False)
    tag = f"per-chain betas {family} d={d} R={R} steps={steps} iters={iters}"
    worst = compare_outputs_equal(tag, rec(states, seeds, b), sample_reference(
        spec, states, seeds, b, iters, False), states)
    kern = make_sweep(spec, iters, False)(states, seed, b)
    plain = sweep_reference(spec, states, seed, b, iters)
    n_bad = int((kern != plain).sum())
    check(n_bad == 0, f"{tag}: sweep differs from plain in {n_bad} entries")
    one = b[:1].expand(R, 3).contiguous()
    for a, c in zip(rec(states, seeds, one), rec(states, seeds, b[0])):
        check(torch.equal(a, c), f"{tag}: one row per chain differs from the "
                                 f"shared row")
    return worst


def phase_per_chain_parity() -> float:
    """K1 at a row of betas per chain (the PT ladder's launch) against its
    plain versions, bit for bit: toric d=5 at the PTDC main path's 327,680
    chains (one step of one sweep, the ladder step's launch), planar d=3
    with a ragged last block, toric d=13 and d=19 (tables in device
    memory)."""
    m = PT_MAIN
    R = m["B"] * 16 * m["droplets"] * m["Nc"]
    cases = [("toric", 5, R, 1, 1), ("planar", 3, 257, 5, 1),
             ("toric", 13, 1000, 3, 2), ("toric", 19, 256, 2, 1)]
    worst = 0.0
    for i, (family, d, n, steps, iters) in enumerate(cases):
        worst = max(worst, compare_per_chain(family, d, n, steps, iters,
                                             seed=120 + i))
    print(f"phase 17 sweep kernel at a row of betas per chain vs plain: "
          f"{'; '.join(f'{f} d={d} R={n} steps={st} iters={it}' for f, d, n, st, it in cases)}"
          f": recording sampler (states, keys, counts) and sweep equal, one "
          f"row per chain equal to the shared row; max abs err {worst}",
          flush=True)
    return worst


def _per_chain_launch(spec, R, seed=130):
    """The PT ladder step's K1 launch (one recording step of one sweep,
    general branch, a row of betas per chain) at R chains, timed against
    the plain sampler on the same inputs: outputs equal; (ms, plain ms,
    err, bound, bound_by)."""
    states = _random_states(spec, R, seed)
    b = _chain_rows(R, 5, 0.1, seed)
    seeds = torch.randint(0, 2**62, (1,),
                          generator=torch.Generator().manual_seed(seed)).cuda()
    rec = make_recording_sweep(spec, 1, 1, equal_betas=False)
    kern = rec(states, seeds, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: rec(states, seeds, b), 50)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sample_reference(
        spec, states, seeds, b, 1, False)), 1)
    err = compare_outputs_equal(f"ladder-step launch, {R} chains", kern,
                                plain_out[0], states)
    bound, bound_by = sampler_bound(spec, R, 1, 1, False,
                                    _nbytes(states, b, seeds, *kern))
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)


def _ladder_states(m, seed):
    spec = get_spec("toric", m["d"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],), device="cuda")
    return spec, states, np_eq_class(spec, states.cpu().numpy())


def _pt_decode(name, fn, spec, states, m):
    """One decode of ``fn`` (PTDC or PTRC) at the main path's budget with
    the stream timing on: (percentages, seconds, peak bytes, sweep
    launches, plain calls, stream windows, {part: device ms}, what its
    truncation warning saw)."""
    kw = dict(droplets=m["droplets"], Nc=m["Nc"], device="cuda")
    # warm-up: one stream window at B=16 (allocator, sorts, first launches)
    fn(spec, states[: m["warm_B"]], m["p"], steps=m["Nc"] * m["window"],
       seed=1, stream=True, **kw)
    seen = {}
    if name == "PTDC":
        warn = ptdc_mod.warn_stream_overflow

        def record(overflow, max_kept, min_rank, n_samples, *a, **k):
            seen.update(rows=int(np.asarray(overflow).sum()), bound=float(
                stream_deficit_bound(overflow, max_kept, min_rank,
                                     n_samples).max()))
            return warn(overflow, max_kept, min_rank, n_samples, *a, **k)

        attr = "warn_stream_overflow"
    else:
        warn = ptdc_mod._warn_occupancy_truncation

        def record(trunc_bad, *a, **k):
            seen.update(cells=int(np.asarray(trunc_bad).sum()))
            return warn(trunc_bad, *a, **k)

        attr = "_warn_occupancy_truncation"
    setattr(ptdc_mod, attr, record)
    stream_timing.enabled = True
    try:
        stream_timing.reset()
        sweep_counts.reset()
        distr, dt, peak = _peak(lambda: fn(spec, states, m["p"],
                                           steps=m["steps"], seed=3, **kw))
        launches, plain = sweep_counts.launches, sweep_counts.plain_calls
        windows, split = stream_timing.windows, stream_timing.ms()
    finally:
        setattr(ptdc_mod, attr, warn)
        stream_timing.enabled = False
    return distr, dt, peak, launches, plain, windows, split, seen


def phase_pt_main_path():
    """PTDC and PTRC at the JAX pipeline's defaults (PT_MAIN), stream
    "auto" (which must stream): one sweep-kernel launch per ladder step
    (3125), no plain call; syn/s after a warm-up, the device-time split of
    the ladder steps' sweeps and exchanges, the windows' record copies and
    the merges (CUDA events), peak memory, what the capacity truncated,
    and the truth recovery (at least PT_MAIN["min_recovered"]); the first
    64 syndromes again with buffers that never overflow, against the
    default capacities; then one ladder-step launch at 327,680 chains
    against the plain sampler."""
    m = PT_MAIN
    spec, states, truth = _ladder_states(m, 2029)
    B, K, D, Nc = m["B"], spec.n_classes, m["droplets"], m["Nc"]
    n_steps = m["steps"] // Nc
    n_win = -(-n_steps // m["window"])
    check(should_stream("auto", B * K, D * Nc, n_steps),
          "stream='auto' does not resolve to streaming at this budget")
    lines, out = [], {}
    for name, fn in (("PTDC", PTDC), ("PTRC", PTRC)):
        distr, dt, peak, launches, plain, windows, split, seen = _pt_decode(
            name, fn, spec, states, m)
        check(launches == n_steps, f"{name}: {launches} sweep launches, not "
                                   f"{n_steps}")
        check(plain == 0, f"{name}: the plain sampler ran {plain} times")
        check(windows == n_win, f"{name}: {windows} windows, not {n_win}")
        check(distr.shape == (B, K) and distr.dtype == np.uint8,
              f"{name}: percentages {distr.shape} {distr.dtype}")
        tot = distr.astype(int).sum(1)
        check(bool(((tot >= 100 - K) & (tot <= 100)).all()),
              f"{name}: percentages sum to {tot.min()}..{tot.max()}")
        rec = float(np.mean(distr.argmax(1) == truth))
        check(rec >= m["min_recovered"], f"{name}: truth recovered {rec:.3f}")
        out[name] = dict(launches=launches, distr=distr)
        parts = ", ".join(f"{k} {split.get(k, 0.0):.1f}" for k in
                          ("sweep", "exchange", "sample", "merge"))
        lines.append(
            f"{name} {B / dt:.2f} syn/s ({dt:.2f} s), {launches} sweep "
            f"launches ({launches / n_steps:.0f} per ladder step), {windows} "
            f"windows, device ms: {parts} (sample = the windows' ladder "
            f"steps and record copies; event spans, so a part's host launch "
            f"gaps count in it); peak {peak / 1e9:.2f} GB; {seen}; truth "
            f"recovered {rec:.3f}")
    agree = float(np.mean(out["PTDC"]["distr"].argmax(1)
                          == out["PTRC"]["distr"].argmax(1)))
    # what the default capacities truncate: the first syndromes again with
    # buffers above a row's samples (PTDC 62,500 a (syndrome, class), PTRC
    # 12,500 a rung), which never overflow
    Bc = m["capacity_B"]
    cap = []
    for name, fn, big in (("PTDC", PTDC, 65536), ("PTRC", PTRC, 16384)):
        full = fn(spec, states[:Bc], m["p"], droplets=D, Nc=Nc,
                  steps=m["steps"], seed=3, stream_capacity=big,
                  device="cuda").astype(int)
        small = out[name]["distr"][:Bc].astype(int)
        cap.append(f"{name} at capacity {big}: max |diff| "
                   f"{int(np.abs(full - small).max())} points, argmax changed "
                   f"in {int((full.argmax(1) != small.argmax(1)).sum())} rows, "
                   f"truth recovered {float(np.mean(full.argmax(1) == truth[:Bc])):.3f} "
                   f"(default capacity "
                   f"{float(np.mean(small.argmax(1) == truth[:Bc])):.3f})")
    R = B * K * D * Nc
    launch = _per_chain_launch(spec, R)
    print(f"phase 18 PTDC and PTRC at the JAX pipeline's defaults, toric "
          f"d={m['d']} B={B} p={m['p']} p_sampling={m['p']} droplets={D} "
          f"Nc={Nc} steps={m['steps']} ({n_steps} ladder steps, {R} chains), "
          f"stream='auto' (streams), windows of {m['window']}: "
          + "; ".join(lines) + f"; PTDC and PTRC argmax agree on {agree:.3f}; "
          f"the first {Bc} syndromes again: " + "; ".join(cap) + "; "
          f"one ladder-step launch ({R} chains, one sweep, a row of betas per "
          f"chain): kernel {launch['ms']:.4f} ms, plain sampler "
          f"{launch['plain_ms']:.1f} ms, states, keys and counts equal, bound "
          f"{launch['bound_ms']:.4f} ms ({launch['bound_by']}); launch: "
          f"{sampler_launch_line(spec, R, False)}", flush=True)
    launch["launches"] = out["PTDC"]["launches"]
    return launch


def _launches_per_step(fn, steps) -> str:
    """CUDA kernels and copies a run of ``fn`` starts per recorded step, from
    torch.profiler's device events (and the runtime's launch calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.events()
    dev = sum(e.device_type == DeviceType.CUDA for e in ev)
    calls = sum(e.name in ("cudaLaunchKernel", "cudaMemcpyAsync",
                           "cudaMemsetAsync") for e in ev)
    return (f"{dev / steps:.1f} device kernels and copies, {calls / steps:.1f} "
            f"runtime launch calls per recorded step")


def phase_single_temp_main_path():
    """single_temp at the PTDC main path's shape (toric d=5, B=1024, 16,384
    class chains) and the pipeline's steps (max_iters=15625): syn/s, and
    the launches per recorded step from a profiled run of 50 steps; the
    scores finite and the decision (argmin) recovering the truth at least
    PT_MAIN["min_recovered"] of the time."""
    m = PT_MAIN
    spec, states, truth = _ladder_states(m, 2030)
    single_temp(spec, states[: m["warm_B"]], m["p"], 20, seed=1, device="cuda")
    per_step = _launches_per_step(
        lambda: single_temp(spec, states, m["p"], 51, seed=2, device="cuda"), 51)
    scores, dt = _sync_time(lambda: single_temp(spec, states, m["p"],
                                                m["steps"], seed=3,
                                                device="cuda"))
    check(scores.shape == (m["B"], spec.n_classes)
          and bool(np.isfinite(scores).all()), "single_temp scores not finite")
    rec = float(np.mean(scores.argmin(1) == truth))
    check(rec >= m["min_recovered"], f"single_temp: truth recovered {rec:.3f}")
    print(f"phase 19 single_temp toric d={m['d']} B={m['B']} p={m['p']} "
          f"max_iters={m['steps']} (5 literal proposals a step, "
          f"{m['B'] * spec.n_classes} chains): {m['B'] / dt:.2f} syn/s "
          f"({dt:.2f} s, {dt / m['steps'] * 1e3:.3f} ms a recorded step); "
          f"{per_step}; truth recovered {rec:.3f}", flush=True)


def phase_exact_slice_d3():
    """The slice's decoders on the card against the exact posterior, on
    the JAX tests' d=3 syndromes and to their bars: PTDC (TV < 0.05, same
    argmax), PTRC (same argmax), single_temp (argmin = exact argmax), STDC
    on the sweep engine (TV < 0.03) and PTEQ on the unfused sweep engine
    (argmax among the top two, TV < 0.2) (tests/test_decoders.py:175-195,
    226-249)."""
    def syndrome(key):
        family, s = D3_SYNDROMES[key]
        return get_spec(family, 3), np.asarray(s, np.uint8)

    def exact_of(spec, s0, p):
        return exact_mld(spec, s0[None], betas_depolarizing(p))[0]

    parts, fails = [], []

    def tv_check(name, distr, exact, bar, argmax=True):
        d = np.asarray(distr, float) / 100.0
        tv = float(0.5 * np.abs(d - exact).sum())
        same = int(d.argmax()) == int(exact.argmax())
        parts.append(f"{name} TV {tv:.4f} argmax {'equal' if same else 'DIFFERS'}")
        if (bar is not None and tv >= bar) or (argmax and not same):
            fails.append(f"{name}: TV {tv:.4f}, argmax equal {same}")

    spec, s0 = syndrome("planar p=0.1")
    exact = exact_of(spec, s0, 0.1)
    kw = dict(p_sampling=0.25, droplets=2, steps=8000, device="cuda")
    tv_check("PTDC", PTDC(spec, s0[None], 0.1, **kw)[0], exact, 0.05)
    tv_check("PTRC", PTRC(spec, s0[None], 0.1, **kw)[0], exact, None)
    tv_check("STDC sweep", STDC(spec, s0[None], 0.1, 0.25, droplets=4,
                                steps=1500, engine="sweep",
                                device="cuda")[0], exact, 0.03, argmax=False)
    spec, s0 = syndrome("planar p=0.08")
    exact = exact_of(spec, s0, 0.08)
    scores = single_temp(spec, s0[None], 0.08, max_iters=3000, device="cuda")[0]
    same = int(scores.argmin()) == int(exact.argmax())
    parts.append(f"single_temp argmin {'equal' if same else 'DIFFERS'}")
    if not same:
        fails.append("single_temp's argmin differs from the exact argmax")
    spec, s0 = syndrome("toric p=0.1")
    exact = exact_of(spec, s0, 0.1)
    res = PTEQ(spec, np.tile(s0[None], (8, 1)), 0.1, PTEQConfig(
        max_steps=8000, window=200, TOPS=30, SEQ=4, iters=2, engine="sweep"),
        seed=3, device="cuda")
    mean = res.distribution.mean(axis=0)
    tv_check("PTEQ sweep", mean, exact, 0.2, argmax=False)
    if int(mean.argmax()) not in np.argsort(exact)[-2:].tolist():
        fails.append("PTEQ sweep: argmax not among the exact top two")
    print(f"phase 20 d=3 exact checks of the slice's decoders on the card: "
          f"{'; '.join(parts)}", flush=True)
    check(not fails, "; ".join(fails))


def main() -> int:
    phase = "device"
    try:
        phase_device()
        phase = "build"
        phase_build()
        phase = "window kernel vs plain"
        max_err = phase_parity()
        phase = "PTEQ main path"
        k2_launches = phase_main_path()
        phase = "h2h PTEQ quality"
        pteq_distr = phase_quality()
        phase = "window timing"
        k2 = phase_timing()
        phase = "sweep kernel vs plain"
        k1_err = phase_sweep_parity()
        phase = "STDC main path"
        k1_launches = phase_stdc_main_path()
        phase = "h2h STDC/STRC quality"
        phase_counting_quality(pteq_distr)
        phase = "sweep timing"
        k1 = phase_sweep_timing()
        phase = "window kernel vs plain, other branches"
        branch_err = phase_branch_parity()
        phase = "PTEQ_alpha main path"
        gen_launches = phase_biased_main_path()
        phase = "d=3 exact checks"
        phase_exact_d3()
        phase = "general-branch window timing"
        gen = phase_general_timing()
        phase = "streamed vs materialised STDC/STRC"
        phase_stream_parity()
        phase = "STDC at the reference budget, streamed"
        k1_win = phase_stream_main_path()
        phase = "sweep kernel at per-chain betas vs plain"
        pc_err = phase_per_chain_parity()
        phase = "PTDC/PTRC main path"
        k1_pt = phase_pt_main_path()
        phase = "single_temp main path"
        phase_single_temp_main_path()
        phase = "d=3 exact checks of the slice's decoders"
        phase_exact_slice_d3()
    except PhaseFailed as e:
        print(f"FAILED phase {phase}: {e}", flush=True)
        return 1
    k1_main = k1[1]
    print(json.dumps({"kernels": [{
        "name": "ladder_window",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/ladder_window.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_ladder.py:144",
        "launches": k2_launches,
        "max_abs_err": max(max_err, k2["err"]),
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "sweep",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/sweep.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_sweep.py:42",
        "launches": k1_launches,
        "max_abs_err": max(k1_err, k1[1]["err"], k1[100]["err"]),
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
    }, {
        "name": "sweep_sampler",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/sweep.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_sweep.py:42",
        "launches": k1_launches,
        "max_abs_err": max(k1_err, k1["sampler"]["err"]),
        "ms": k1["sampler"]["ms"],
        "plain_ms": k1["sampler"]["plain_ms"],
        "bound_ms": k1["sampler"]["bound_ms"],
        "bound_by": k1["sampler"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "sweep_sampler_window",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/sweep.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_sweep.py:42",
        "launches": k1_win["launches"],
        "max_abs_err": max(k1_err, k1_win["err"]),
        "ms": k1_win["ms"],
        "plain_ms": k1_win["plain_ms"],
        "bound_ms": k1_win["bound_ms"],
        "bound_by": k1_win["bound_by"],
        "library_ms": None,
    }, {
        "name": "sweep_per_chain",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/sweep.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_sweep.py:42",
        "launches": k1_pt["launches"],
        "max_abs_err": max(pc_err, k1_pt["err"]),
        "ms": k1_pt["ms"],
        "plain_ms": k1_pt["plain_ms"],
        "bound_ms": k1_pt["bound_ms"],
        "bound_by": k1_pt["bound_by"],
        "library_ms": None,
    }, {
        "name": "ladder_window_general",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/ladder_window.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_ladder.py:144",
        "launches": gen_launches,
        "max_abs_err": max(branch_err, gen["err"]),
        "ms": gen["ms"],
        "plain_ms": gen["plain_ms"],
        "bound_ms": gen["bound_ms"],
        "bound_by": gen["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
