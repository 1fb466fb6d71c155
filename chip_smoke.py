"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from mcmc_qec_tpu_torch/csrc with nvcc (one process per
source, started together), then drives each ported path and holds each
kernel against its plain PyTorch version on the card:

- K2, the PT window (csrc/ladder_window.cu): kernel vs plain version,
  also with a ragged last block, at 1 to 32 lanes per rung and with
  multi-warp groups, and at iters=10 at the lanes ``window_lanes`` picks
  and at 8 and 16; depolarizing PTEQ at production size through the
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
- The stream merge (csrc/stream_merge.cu, one launch a stream window)
  against the plain merge, ``decoders/streaming.py::_merge_row``, all five
  outputs bit for bit, on adversarial windows from an empty buffer to an
  overflowing one (duplicates, integer ties, dead and invalid candidates,
  -0.0, C < S and C > S, a partial window, the largest shape it admits);
  the streamed STDC, STRC, PTDC and PTRC decodes through it against the
  plain merge, equal bit for bit; the STDC bench cell's merge timed
  against the plain merge, with its share of the card's memory rate.
- K1 at a row of betas per chain, the PT ladder step's launch: kernel vs
  plain version (toric d=5 at 327,680 chains, planar d=3 ragged, toric
  d=13 and d=19), and one row per chain equal to the shared row; PTDC and
  PTRC at the JAX pipeline's defaults (toric d=5, B=1024, droplets=4,
  Nc=5, 3125 ladder steps, streamed), one sweep launch per ladder step and
  no plain call, with the device-time split of sweeps, exchanges and
  merges; single_temp at the same shape; PTDC, PTRC, single_temp, STDC on
  the sweep engine and PTEQ on the unfused sweep engine against the exact
  posterior at d=3.
- The user's entry point, both kernels through it: PTEQ at the production
  shape through ``python -m mcmc_qec_tpu_torch generate`` (a subprocess),
  equal bit for bit to a direct ``PTEQ`` call on the same syndromes, with
  the pipeline's host stages; PTDC at the JAX pipeline's defaults through
  the CLI (3125 sweep launches); planar d=5 through MWPM, eMWPM and STDC
  warm-started by the blossom matcher (built with g++ here); ``concat``
  and ``evaluate``.  Then a checkpointing PTEQ decode at the production
  shape killed after its 2nd snapshot (``python3 chip_smoke.py
  --ckpt-worker DIR``) and resumed, equal bit for bit to the uninterrupted
  decode.
- Multi-device runs on ``torch.distributed``, both kernels through them:
  PTEQ at the production shape through ``python -m mcmc_qec_tpu_torch
  generate --distributed`` with two ranks sharing the card (``python3
  chip_smoke.py --rank-worker ARGS``, the CLI run as ``-m`` runs it, with
  the rank's launches and span recorded), the merged file equal bit for
  bit to the ranks' runs in process, the merged syn/s against one
  process's; STDC at the bench key's shape over two ranks with a ragged
  last shard; ``graft_entry.dryrun_multichip`` over every card; STDC
  through ``parallel.map_shards`` over a one-card mesh (equal to the
  unsharded call) and over the card listed twice; a world of one.
  ``--ckpt-worker`` and ``--rank-worker`` are the only arguments the
  script takes, each run by the script itself.
- The threshold studies (``mcmc_qec_tpu_torch/studies``), each through its
  main: depolarizing PTEQ at p=0.19 on toric d=5, 9 and 13 and biased
  eta=10 PTEQ_alpha at p=0.275 on xzzx d=5 and 13 (512 syndromes at the
  caps of the committed TPU grids), STDC failure rates at toric d=5 and the
  uncorrelated MWPM/STDC study at planar d=5; each cell within 4 sigma of
  the committed grid's cell where there is one, and each launching its
  kernel; at toric d=13 the window's launch, compaction, the host's work
  between points and one production window against the plain version.
- Codes beyond d=13, both kernels at their 2-spanned-word and 16-word
  shapes: kernel vs plain version at xzzx d=15 and 17, rotated d=15 and
  23, toric d=21 (K2 in every branch and mode, K1 sweeps, recording
  sampler and a row of betas per chain, also at the fewest lanes per
  chain); PTEQ_alpha at xzzx d=17 (the biased study one size up), PTEQ at
  rotated d=19 and toric d=21 and STDC at rotated d=19 through the
  kernels only, against failure and recovery bars, each with one window or
  sampler launch timed against the plain version; PTEQ_alpha at xzzx d=31
  on the unfused window through K1 (``engine="sweep"``).
- The golden-corpus studies (``studies.golden_replay``,
  ``studies.golden_ceiling``) through their ``run`` on 256 toric d=5
  syndromes drawn on the card (not the DRL failure set): PTEQ (K2), STDC
  (K1) and the ceiling with its MWPM row.
- Codes above 1024 qubits, K1's large variant (2 bits a qubit in shared
  memory, a proposal one qubit-table entry, the recording kept up to date
  flip by flip, up to 1024 threads a block in whole waves): kernel vs
  plain version at toric d=23, 33 and 45 and rotated d=33 (17 to 64 words
  per plane) at every lane count, and at toric d=23 with a ragged last
  block at the plan's thread count, sweeps and recording sampler, equal,
  general and per-chain betas; its registers (0 B spilled, or the phase
  fails), and 10 sweeps at toric d=45 against the bound; STDC at toric
  d=25 and rotated d=45 (recovery bar), PTEQ at toric d=23 on the unfused
  window (``engine="sweep"``) and PTDC at toric d=23 through K1 only, one
  launch a ladder step, each with one launch timed against the plain
  version and its launch (lanes, threads, chains and warps an SM, waves)
  and its seconds and launches beside the parent's.
- The window kernel above 16 words, K2's large variant (planes in shared
  memory): kernel vs plain version at toric d=23 and d=25, planar d=27,
  rotated d=33, xzzx d=31 (16 words at 31 rungs) and d=37, every branch,
  trace mode, even_odd, zeros, a fixed word and Philox, 1 to 32 lanes a
  rung, a ragged last block; its registers and spills; PTEQ at toric
  d=23 (one K2 launch a window, no K1) against the unfused decode of the
  same call, PTEQ_alpha at xzzx d=33 against a failure bar, PTEQ at toric
  d=25 B=128 with one window against its bound and the plain version, and
  the large variant beside the register form at toric d=21.
- The redesigned large variant (2 bits a qubit, a proposal one table
  entry and four 32-bit loads, up to 1024 threads a block), which
  ``window_form`` gives every code of 12 words per plane or more: kernel
  vs plain version and vs the register form on the same inputs at toric
  d=17, 19 and 21, planar d=21, rotated d=27 and 29 and xzzx d=25, at the
  plan's lanes and at 16 and 32; phase 25's PTEQ at toric d=21 through it;
  W=60 windows at toric d=23 B=16, xzzx d=33 B=64 and toric d=25 B=128
  and B=1024 against their bounds.
- The benchmark's biased-noise cell (port_bench's configuration
  ``pteq_alpha_xzzx13`` under its traffic ``eta10_p0275_b512``): one
  request of 512 XZZX d=13 syndromes through ``PTEQ_alpha`` with the
  recorder on (every launch the large variant with per-Pauli betas), then
  a window of each form K2 takes as compaction shrinks that batch (the
  large variant at 512 rows, the register form at 16 lanes a rung at 128)
  on the cell's ladder against the plain version.

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
import mcmc_qec_tpu_torch.decoders.streaming as streaming_mod
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
import mcmc_qec_tpu_torch.ops.kernel_tables as kt
import mcmc_qec_tpu_torch.ops.ladder_window as lw
from mcmc_qec_tpu_torch.ops import _build
from mcmc_qec_tpu_torch.ops.kernel_tables import kernel_tables
from mcmc_qec_tpu_torch.ops.ladder_window import (
    _N_EXTRA_USES,
    _rng_layout,
    ladder_window_counts,
    ladder_window_reference,
    launch_plan,
    make_ladder_window,
)
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.ops.pauli import (
    count_errors_xyz,
    make_hash_mults,
    pack_key,
    random_logical,
)
from mcmc_qec_tpu_torch import cli, native
import mcmc_qec_tpu_torch.parallel as parallel
from mcmc_qec_tpu_torch.graft_entry import dryrun_multichip
from mcmc_qec_tpu_torch.parallel import (
    Mesh,
    distributed_generate,
    init_distributed,
    make_mesh,
    map_shards,
    shard_batch,
)
from mcmc_qec_tpu_torch.matching import class_sorted_mwpm_batch
from mcmc_qec_tpu_torch.pipeline import (
    Dataset,
    evaluate_dataset,
    generate,
    sample_errors,
)
from mcmc_qec_tpu_torch.pipeline.generate import error_generator
from mcmc_qec_tpu_torch.utils import CheckpointManager, profiling
import mcmc_qec_tpu_torch.utils.roofline as roofline
from mcmc_qec_tpu_torch.utils.roofline import (
    HBM_BYTES_PER_S,
    philox_blocks_per_sweep,
    popc_per_sweep,
)
from mcmc_qec_tpu_torch.ops.stream_merge import (
    merge_kernel_fits,
    merge_window,
    stream_merge_counts,
)
from mcmc_qec_tpu_torch.ops.sweep import (
    make_recording_sweep,
    make_sweep,
    sample_reference,
    sweep_counts,
    sweep_reference,
)

KERNELS = ("ladder_window", "sweep", "stream_merge")
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
# the pipeline on the card (phase 21): (a) PTEQ at the production shape
# through `python -m mcmc_qec_tpu_torch generate` (energy_chunk stays at
# the pipeline's 4), (b) PTDC at the JAX pipeline's defaults through the
# CLI, (c) planar d=5 through MWPM, eMWPM and STDC warm-started by the
# matcher, on one seed
PIPE_PTEQ = dict(d=5, B=2048, p=0.15, iters=2, window=600, max_steps=24000,
                 seed=2027, warm_B=64)
PIPE_PTDC = dict(d=5, B=1024, p=0.1, seed=2028)
PIPE_PLANAR = dict(d=5, p=0.1, n=1024, seed=2029, methods=("MWPM", "eMWPM",
                                                           "STDC"))
# PTEQ killed after its 2nd snapshot and resumed (phase 22): the
# production shape with snapshots every 5 windows
CKPT_MAIN = dict(d=5, B=2048, p=0.15, iters=2, window=600, energy_chunk=12,
                 max_steps=24000, ckpt_every=5, kill_after=2, seed=2030)
# multi-device on the card (phase 23): (a) PTEQ at the production shape
# through `generate --distributed`, two ranks sharing the card, one batch
# of 2048 each; (b) STDC at the bench key's shape, 2047 points over two
# ranks (1024 + 1023); each rank warms up on DIST_WARM points before its
# counts start; (c) the mesh: the dry run, then STDC at (b)'s shape over a
# one-card mesh and over a mesh that lists the card twice; (d) a world of
# one process
DIST_PTEQ = dict(PIPE_PTEQ, seed=2031, n=4096, ranks=2)
DIST_STDC = dict(STDC_MAIN, d=5, seed=2032, n=2047, ranks=2)
DIST_WARM = 64
# the threshold studies on the card (phase 24), each through its study's
# main as a user runs it (mcmc_qec_tpu_torch/studies): depolarizing PTEQ
# at p=0.19 on toric d=5, 9, 13 at the caps of examples/
# threshold_grid_r4.json, biased eta=10 at p=0.275 on xzzx d=5 and 13
# (threshold_eta10_r5.json's caps, the study's default), STDC failure
# rates at toric d=5 p=0.10, and the uncorrelated study at planar d=5 pk=16
# (p=0.139); 512 or 256 syndromes a cell.  A cell with a committed
# counterpart must lie within 4 sigma of it (both binomials).
STUDY_DEPOL = dict(p=0.19, sizes=(5, 9, 13), n=512,
                   caps={5: 48000, 9: 36450, 13: 109850})
STUDY_BIASED = dict(eta=10.0, p=0.275, sizes=(5, 13), n=512)
STUDY_FAILURE = dict(d=5, p=0.10, n=256)
STUDY_UNCORR = dict(d=5, pk=16, n=256)
STUDY_MAX_SIGMA = 4.0
# codes beyond d=13 on the card (phase 25).  (a) K2 against its plain
# version at the new instantiations: (family, d, Nc, B, W, branch, exchange,
# traces, rng); B=300 leaves a ragged last block of several syndromes.
# (b) K1 against its plain versions at the same codes, also at a batch
# that takes the fewest lanes per chain (1 at rotated d=19, 2 at toric
# d=21), and at a row of betas per chain at xzzx d=31 (the unfused
# window's launch there).  (c) Decodes through the entry points: PTEQ_alpha
# at the biased study's configuration one size up (xzzx d=17, eta=10,
# p=0.20, the study's cap 15 d**3); at p=0.05 PTEQ at rotated d=19 and
# toric d=21 and STDC (engine "auto") at rotated d=19; and PTEQ_alpha at
# xzzx d=31 on the unfused window (``engine="sweep"``: K2 holds its 31-rung
# ladder only in its large variant, phase 28, so the sweep kernel's
# per-chain launch stays on a PTEQ path here).  Toric d=21's ladder rarely swaps its bottom pair (p=0.05
# against 0.085 over 882 qubits): a chain passes from top to bottom about
# once in 20,000-24,000 steps, so every row needs a cap of 240,000 to pass
# the burn gate of two passes (at 12,000 no row did, at 48,000 the median
# row).  Bars: xzzx d=17 fails no more often than the JAX study's d=13
# (0.0767) + 0.025; the p=0.05 decodes recover the true class on at least
# 0.99 of rows.  One window (W=60) of each decode's kernel is timed against
# its plain version at the decode's shape.
LARGE_K2 = [
    ("xzzx", 15, 15, 300, 24, "general-exact", "sequential", True, "philox"),
    ("xzzx", 15, 15, 128, 24, "general-mh", "even_odd", False, "zeros"),
    ("xzzx", 15, 15, 128, 24, "general-mh", "sequential", True, 0x9E3779B9),
    ("xzzx", 17, 17, 300, 24, "general-exact", "even_odd", False, "philox"),
    ("xzzx", 17, 17, 128, 24, "general-mh", "sequential", True, "philox"),
    ("rotated", 15, 15, 300, 24, "equal-exact", "sequential", True, "philox"),
    ("rotated", 15, 15, 128, 24, "equal-exact", "even_odd", False, "zeros"),
    ("rotated", 23, 23, 128, 12, "equal-exact", "sequential", True, "philox"),
    ("rotated", 23, 23, 64, 12, "general-mh", "even_odd", False, "philox"),
    ("toric", 21, 21, 64, 8, "equal-exact", "sequential", True, "philox"),
    ("toric", 21, 21, 32, 8, "general-mh", "even_odd", False, "philox"),
]
LARGE_K1 = [("xzzx", 15, 300), ("xzzx", 17, 300), ("rotated", 15, 300),
            ("rotated", 23, 128), ("toric", 21, 128)]
LARGE_K1_WIDE = [("rotated", 19, 70000), ("toric", 21, 70000)]
LARGE_ALPHA = dict(family="xzzx", d=17, eta=10.0, p=0.20, B=512,
                   max_steps=73695)
LARGE_PTEQ = [dict(family="rotated", d=19, p=0.05, B=512, max_steps=24000),
              dict(family="toric", d=21, p=0.05, B=64, max_steps=240000)]
LARGE_STDC = dict(family="rotated", d=19, p=0.05, B=1024, p_sampling=0.15,
                  droplets=4, steps=450)
LARGE_FALLBACK = dict(family="xzzx", d=31, p=0.05, B=16, max_steps=48,
                      window=24)
LARGE_MAX_FAILURE = BIASED_REF_FAILURE + BIASED_MAX_FAILURE_GAP
LARGE_MIN_RECOVERED = 0.99
LARGE_TIMED_W = 60
# codes above 1024 qubits (phase 27), the sweep kernel's large variant
# (csrc/sweep.cu::sweep_kernel_wide): (a) parity at 17, 18, 35 and 64 words
# per plane (family, d, chains: ragged warps at every lane count; toric
# d=23 at 5,000 chains: 132 blocks of 38 chains at the plan's 16 lanes and
# 19 warps, the last block holding 22); (b) one launch of each timed
# against its bound and the plain version; (c) decodes through the entry
# points.  STDC runs 4 droplets x 450 steps (recovery printed: too few
# samples for these sizes) and then WIDE_STDC_BUDGET, which carries the
# bar
WIDE_PARITY = [("toric", 23, 37), ("rotated", 33, 40), ("toric", 33, 33),
               ("toric", 45, 35), ("toric", 23, 5000)]
WIDE_TIMED = dict(family="toric", d=45, R=16384, n_sweeps=10)
WIDE_STDC = [dict(family="toric", d=25, p=0.05, p_sampling=0.15, B=256),
             dict(family="rotated", d=45, p=0.05, p_sampling=0.15, B=128)]
WIDE_STDC_FIRST = dict(droplets=4, steps=450)
WIDE_STDC_BUDGET = dict(droplets=10, steps=1500)
WIDE_MIN_RECOVERED = 0.98
WIDE_PTEQ = dict(family="toric", d=23, p=0.05, B=16, max_steps=1200)
WIDE_PTDC = dict(family="toric", d=23, p=0.05, B=16, droplets=1, steps=23 * 20)
# phase 27 (c)'s decodes on the sweep kernel's large variant before its
# redesign (commit e85e7d7's chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W; PERF.md): seconds, K1 launches
WIDE_PARENT = {"STDC toric d=25": (2.03, 4), "STDC rotated d=45": (0.35, 1),
               "PTEQ toric d=23": (6.62, 1200), "PTDC toric d=23": (0.07, 20)}
# the window kernel above 16 words and for ladders too large for its
# registers (phase 28), K2's large variant
# (csrc/ladder_window.cu::ladder_window_kernel_wide): (a) parity against
# the plain version: (family, d, Nc, B, W, branch, exchange, traces, rng,
# lanes per rung or None for the plan's); B=263 leaves a ragged last block
# (2 syndromes a block on 132 SMs), Nc=3 at 32 and 1 lanes and other
# counts move the rung masks; xzzx d=31 at 31 rungs is a 16-word code;
# (c) decodes through the entry points: PTEQ at toric d=23 as phase 27
# runs it unfused, and PTEQ_alpha at xzzx d=33 (the biased study's cell,
# eta=10, p=0.20) at a capped step count, failure held to phase 25's bar;
# (d) PTEQ at toric d=25, B=128, with one window timed against the bound
# and the plain version
WIDE_K2 = [
    ("toric", 23, 23, 263, 24, "equal-exact", "sequential", True, "philox", None),
    ("toric", 23, 23, 64, 24, "general-mh", "even_odd", False, "philox", None),
    ("toric", 23, 3, 64, 24, "equal-exact", "even_odd", True, "philox", 32),
    ("toric", 23, 3, 64, 24, "general-mh", "sequential", False, "philox", 1),
    ("toric", 25, 25, 64, 24, "equal-exact", "sequential", False, "zeros", None),
    ("toric", 25, 25, 64, 24, "general-exact", "even_odd", True, "philox", 2),
    ("planar", 27, 27, 64, 24, "equal-exact", "sequential", True, "philox", None),
    ("planar", 27, 27, 64, 24, "general-mh", "even_odd", False, 0x9E3779B9, None),
    ("rotated", 33, 33, 64, 24, "equal-exact", "even_odd", True, "philox", None),
    ("rotated", 33, 33, 64, 24, "general-mh", "sequential", True, "philox", 4),
    ("xzzx", 31, 31, 64, 24, "general-exact", "sequential", True, "philox", None),
    ("xzzx", 31, 31, 64, 24, "general-mh", "even_odd", False, "zeros", None),
    ("xzzx", 37, 37, 64, 24, "general-exact", "even_odd", True, "philox", None),
    ("xzzx", 37, 37, 64, 24, "general-mh", "sequential", False, 0x9E3779B9, None),
]
WIDE_K2_ALPHA = dict(family="xzzx", d=33, eta=10.0, p=0.20, B=64,
                     max_steps=12000)
WIDE_K2_TIMED = dict(family="toric", d=25, p=0.05, B=128, max_steps=1200)
# the redesigned large variant (phase 29), which ``window_form`` gives the
# 12- and 16-word codes, which have no register build: (a) every output
# equal to the plain version's (family, d, Nc, B, W, branch, exchange,
# traces, rng, lanes per rung or None for the plan's; B=263 puts two
# syndromes on an SM); (b) phase 25's PTEQ at
# toric d=21, B=64, through the form ``window_form`` picks; (c) W=60
# windows against their bounds: phase 28's at toric d=23 B=16, xzzx d=33
# B=64 and toric d=25 B=128, and a PTEQ window at toric d=25 B=1024 (four
# syndromes a block at eight lanes a rung, two waves)
FORMS_K2 = [
    ("toric", 21, 21, 64, 24, "equal-exact", "sequential", True, "philox", None),
    ("toric", 21, 21, 32, 24, "general-mh", "even_odd", False, "philox", 16),
    ("rotated", 29, 29, 128, 24, "equal-exact", "even_odd", True, "philox", None),
    ("rotated", 29, 29, 64, 24, "general-exact", "sequential", False, 0x9E3779B9, 32),
    ("planar", 21, 21, 64, 24, "general-mh", "sequential", True, "philox", None),
    ("toric", 19, 19, 263, 24, "equal-exact", "sequential", False, "philox", None),
    ("toric", 17, 17, 64, 24, "general-exact", "even_odd", True, "zeros", 32),
    ("rotated", 27, 27, 128, 24, "equal-exact", "sequential", True, "philox", 16),
    ("xzzx", 25, 25, 64, 24, "general-mh", "even_odd", False, "philox", None),
]
WIDE_K2_BATCH = dict(family="toric", d=25, p=0.05, B=1024, max_steps=600)
# the benchmark's biased-noise cell (phase 30): port_bench's configuration
# and traffic files, one request decoded as the cell decodes it; then a
# W=60 window at each (rows, form, lanes a rung) K2 takes for the cell's
# ladder at the batches compaction leaves (512 -> 256 -> 128), the large
# variant at the first, the register form at the last
ALPHA_CELL = dict(config="pteq_alpha_xzzx13", traffic="eta10_p0275_b512",
                  seed=2034, W=60, windows=((512, "large", None),
                                            (128, "registers", 16)))
# the golden-corpus studies on the card (phase 26): 256 toric d=5
# syndromes drawn at p=0.15 (not the DRL failure set, which is not in the
# repository), through studies.golden_replay.run (PTEQ at its production
# configuration; STDC with engine "auto") and studies.golden_ceiling.run
# (--limit 256 --cap 32000, with its MWPM row)
GOLDEN = dict(d=5, p=0.15, n=256, seed=2033, cap=32000)
# the materialised stream in the port's form: int64 key halves and int32
# counts, 28 bytes a sample
PORT_BYTES_PER_SAMPLE = 28

# The least time the card could take (the larger of the bytes over the
# memory rate and the operations over their issue rate): the work counts
# and rates are mcmc_qec_tpu_torch/utils/roofline.py's; this script reads
# the card's SM count and clock (``_card_rates``).


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


def phase_build():
    """One nvcc per source, all started together; returns {name: Built}."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, b in built.items():
        how = f"{b.seconds:.1f} s" if b.seconds else "reused existing build"
        print(f"phase 2 build: {name}.cu {how} | {' | '.join(ptxas_summary(b.log))}",
              flush=True)
        _build.load(name)
    return built


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


def bound_ms(n_bytes: float, popc: float, philox_blocks: float,
             imad: float = 0.0):
    """(least ms, "bytes" or "operations") of ``roofline.bound_ms`` at this
    card's SM count and clock."""
    n_sm, clock = _card_rates()
    return roofline.bound_ms(n_bytes, popc, philox_blocks, imad, n_sm=n_sm,
                             clock_hz=clock)


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
                   both_swaps=True, lanes=None, form=None):
    """Kernel vs plain version on the card, same inputs and draws; returns
    the largest absolute difference over all outputs.  ``lanes`` overrides
    the lanes per rung, ``form`` the form ``window_form`` picks."""
    spec = get_spec(family, d)
    inputs = _ladder_inputs(spec, B, Nc, seed, "cuda")
    ladder, weights = branch_ladder(branch, p, Nc)
    betas = torch.as_tensor(ladder, dtype=torch.float32, device="cuda")
    w = np.asarray(weights, np.float32)
    top_exact, equal_betas = BRANCHES[branch]
    kw = dict(top_exact=top_exact, equal_betas=equal_betas, exchange=exchange,
              track_traces=traces)
    default_lanes = lw.lanes_per_rung, lw.window_lanes, lw.wide_lanes
    try:
        if lanes is not None:
            lw.lanes_per_rung = lambda offs, Nc: lanes
            lw.window_lanes = lambda *args: lanes
            lw.wide_lanes = lambda offs, Nc, per_sm: lanes
        with _window_form(form):
            kern = make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, rng=rng,
                                      **kw)(*inputs, seed, betas, w)
        torch.cuda.synchronize()
    finally:
        lw.lanes_per_rung, lw.window_lanes, lw.wide_lanes = default_lanes
    plain = ladder_window_reference(
        spec, *inputs, seed, betas, w, window=W, iters=iters, p_logical=0.5,
        tops_burn=2, energy_chunk=C, rng=rng, **kw)
    tag = (f"{family} d={d} Nc={Nc} B={B} {branch} {exchange} traces={traces} "
           f"{rng} lanes={lanes or 'default'} form={form or 'picked'}")
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
    # the production ladder's iters=10 at the lanes ``window_lanes`` picks
    # and at 8 and 16 lanes per rung (two- and three-warp groups)
    for lanes in (None, 8, 16):
        worst = max(worst, compare_window("toric", 5, 5, 263, 48, 10, 12, 0.15,
                                          "philox", seed=1237, lanes=lanes))
    picked = lw.window_lanes(get_spec("toric", 5), 5, True, 10, 263,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    print(f"phase 3 kernel vs plain on the card: toric d=5 Nc=5 B=256 W=48 "
          f"(philox, zeros), planar d=3 (zeros), toric d=5 B=263 (ragged last "
          f"block) at 4 (one warp per syndrome), 1, 2, 8 and 32 lanes per "
          f"rung, Nc=13 (two warps, named barriers), and iters=10 at the "
          f"picked lanes (L={picked}), 8 and 16: all nine outputs equal, max "
          f"abs err {worst}", flush=True)
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


def time_production_window(spec, B, Nc, p, seed):
    """One production window of the kernel (W=600, iters=2, C=12) vs one of
    the plain version at (spec, B, Nc), from states drawn at p; the nine
    outputs must be equal.  (ms, plain ms, err, bound, bound_by, and the
    proposals, popcounts and Philox blocks the bound counts)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    states = sample_depolarizing(gen, spec, p, (B,), device="cuda")
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(beta_ladder_depolarizing(p, Nc),
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
    err = compare_outputs(f"{spec.family} d={spec.size} B={B} W=600 philox",
                          kern_out, plain_out[0], PROD["window"])
    # the window's work: every proposal of every sweep on every rung, plus
    # the gate, logical-draw and exchange blocks of each (step, syndrome)
    W, iters = PROD["window"], PROD["iters"]
    proposals = B * Nc * W * iters * spec.n_stabs
    _, _, n_xblocks = _rng_layout(spec, Nc, iters)
    blocks = (B * Nc * W * iters * philox_blocks_per_sweep(spec)
              + B * W * 3 * n_xblocks)
    popc = B * Nc * W * iters * popc_per_sweep(spec, True)
    bound, bound_by = bound_ms(
        _nbytes(ls.state, ls.flag, ls.tops0, eq, sb, betas, *kern_out),
        popc, blocks)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by, proposals=proposals, popc=popc,
                blocks=blocks)


def phase_timing():
    """One window of the kernel vs one of the plain version at the main
    path's shape (B=2048, so the launch packs 16 syndromes per block); the
    two outputs must also be equal."""
    spec = get_spec("toric", 5)
    B, Nc = 2048, 5
    r = time_production_window(spec, B, Nc, 0.15, 5)
    print(f"phase 6 one window toric d=5 B={B} Nc={Nc} W=600 iters=2 C=12: "
          f"kernel {r['ms']:.3f} ms, plain version {r['plain_ms']:.1f} ms "
          f"({r['plain_ms'] / r['ms']:.1f}x); all nine outputs equal, max abs "
          f"err {r['err']}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
          f"{r['proposals']} proposals, {r['popc']} 32-bit popcounts, "
          f"{r['blocks']} Philox blocks); launch: "
          f"{launch_line(spec, B, Nc, True)}", flush=True)
    return r


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


def k1_launch_line(spec, R, record, equal_betas) -> str:
    """K1's launch at R chains: lanes per chain, chains per warp and block,
    threads, blocks and waves, chains and warps one SM holds (launched, and
    the occupancy calculator's limit), tables and multipliers in shared or
    device memory."""
    plan, resident = sw.launch_plan(spec, R, record, equal_betas)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-R // plan.chains_per_block)
    wpb = plan.threads // 32
    held = min(resident, -(-blocks // n_sm))
    waves = blocks / (n_sm * max(resident, 1))
    return (f"L={plan.lanes} lanes per chain, {plan.chains_per_warp} chains per "
            f"warp, {plan.chains_per_block} per block of {plan.threads} "
            f"threads, {blocks} blocks ({waves:.2f} waves), "
            f"{held * plan.chains_per_block} chains and {held * wpb} warps per "
            f"SM resident (up to {resident * wpb} by occupancy), tables in "
            f"{'shared' if plan.tab_in_smem else 'device'} memory, multipliers "
            f"in {'shared' if plan.mults_in_smem else 'device'} memory, "
            f"{plan.smem} B shared memory per block")


def sampler_bound(spec, R, steps, iters, equal_betas, n_bytes):
    """(least ms, bound_by) of the recording sampler
    (``roofline.sampler_bound``) at this card's SM count and clock."""
    n_sm, clock = _card_rates()
    return roofline.sampler_bound(spec, R, steps, iters, equal_betas, n_bytes,
                                  n_sm=n_sm, clock_hz=clock)


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
            R * n_sweeps * popc_per_sweep(spec, True),
            R * n_sweeps * philox_blocks_per_sweep(spec))
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
          f"launch: {k1_launch_line(spec, R, True, True)}", flush=True)
    res["sampler"] = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, err=err,
                          bound_ms=bound, bound_by=bound_by)
    return res


COMBOS = [(b, e) for b in BRANCHES for e in ("sequential", "even_odd")]


def phase_branch_parity() -> float:
    """K2's other branches, kernel vs plain version on the card: every
    combination of sweep form and mix kind with both exchange schedules,
    at xzzx d=5 (1 word per plane; Philox and zero draws), xzzx d=13 (3),
    toric d=9 (3, spanning 4) and toric d=11 (4), traces on in half the
    cases of each, in the register form by name (``window_form`` gives
    some of these launches the large variant), so that the register builds
    of 3 and 4 words stay held to the plain version; and xzzx d=13 at 32
    rungs and 10 sweeps a step, whose tables leave no room beside its
    group and are read from device memory."""
    worst, n = 0.0, 0
    for i, (branch, exchange) in enumerate(COMBOS):
        for rng in ("philox", "zeros"):
            worst = max(worst, compare_window(
                "xzzx", 5, 5, 256, 48, 2, 12, 0.15, rng, 300 + i, branch,
                exchange, traces=i % 2 == 0, both_swaps=rng == "philox"))
            n += 1
    for family, d, B, W in (("xzzx", 13, 256, 24), ("toric", 9, 128, 12),
                            ("toric", 11, 64, 8)):
        for i, (branch, exchange) in enumerate(COMBOS):
            worst = max(worst, compare_window(
                family, d, d, B, W, 2, 4, 0.15, "philox", 400 + i, branch,
                exchange, traces=i % 2 == 0, form="registers"))
            n += 1
    # xzzx d=13's four-warp groups with a ragged last block (B=263: 2 per
    # block), and xzzx d=13 with 32 rungs at 10 sweeps a step, whose tables
    # leave no room for the group and are read from device memory
    spec = get_spec("xzzx", 13)
    for i, (branch, exchange) in enumerate(COMBOS[:2]):
        shape = lw.block_shape(kernel_tables(spec)[2], 32, spec.n_classes, 16,
                               _n_sm(), BRANCHES[branch][1], 10,
                               len(spec.logical_draws))
        check(not shape.tab_in_smem, f"xzzx d=13 Nc=32 {branch}: tables in "
              f"shared memory")
        worst = max(worst, compare_window(
            "xzzx", 13, 13, 263, 24, 2, 4, 0.15, "philox", 510 + i, branch,
            exchange, traces=i % 2 == 1))
        worst = max(worst, compare_window(
            "xzzx", 13, 32, 16, 8, 10, 4, 0.15, "philox", 520 + i, branch,
            exchange, traces=i % 2 == 0, form="registers"))
        n += 2
    print(f"phase 11 window kernel vs plain, other branches: {n} cases "
          f"(general/exact, general/Metropolis and equal/exact mix x "
          f"sequential and even_odd exchange; xzzx d=5 Philox and zeros, "
          f"xzzx d=13, toric d=9, toric d=11 Philox; words per plane "
          f"1/3/3/4; xzzx d=13 B=263 ragged; xzzx d=13 Nc=32 iters=10, its "
          f"tables in device memory): all outputs equal, traces included, "
          f"max abs err {worst}", flush=True)
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
    proposals = B * Nc * W * iters * spec.n_stabs
    _, _, n_xblocks = _rng_layout(spec, Nc, iters)
    blocks = (B * Nc * W * iters * philox_blocks_per_sweep(spec)
              + B * W * (_N_EXTRA_USES - 1) * n_xblocks)
    popc = B * Nc * W * iters * popc_per_sweep(spec, False)
    bound, bound_by = bound_ms(_nbytes(*args[:5], betas, *kern_out), popc,
                               blocks)
    print(f"phase 14 one general-branch window xzzx d={m['d']} B={B} Nc={Nc} "
          f"W={W} iters={iters} C={C} (alpha ladder, exact mix): kernel "
          f"{ms:.3f} ms, plain version {plain_ms:.1f} ms ({plain_ms / ms:.1f}x); "
          f"all outputs equal, max abs err {err}; bound {bound:.4f} ms "
          f"({bound_by}; {proposals} proposals, {popc} 32-bit popcounts, "
          f"{blocks} Philox blocks); launch: "
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


# the stream merge kernel (csrc/stream_merge.cu) against the plain merge:
# (name, rows, slots C, candidates S a row, rank kind, distinct chains a
# row's pool, windows merged in turn from an empty buffer)
MERGE_CASES = (
    ("duplicates", 64, 4096, 4096, "weighted", 1500, 4),
    ("integer ranks, many ties", 64, 2048, 1024, "integer", 3000, 4),
    ("+inf, -inf, NaN and invalid", 64, 4096, 4096, "dead", 3000, 3),
    ("-0.0 beside +0.0", 64, 1024, 4096, "zeros", 2000, 3),
    ("C < S, overflowing", 64, 512, 4096, "weighted", 20000, 4),
    ("C > S", 64, 4096, 1024, "weighted", 20000, 5),
    ("partial last window (S = 4 x 265)", 64, 4096, 1060, "weighted", 20000,
     3),
    ("one candidate, one slot", 64, 1, 1, "integer", 3, 4),
    ("PTDC across rungs (S = 5120)", 64, 4096, 5120, "weighted", 30000, 3),
    ("largest admitted S and C", 8, 65535, 8192, "weighted", 40000, 3),
)
# the STDC cell's merge (port_bench stdc_toric5.p010_b1024): toric d=5,
# B=1024 x 16 classes, 4 droplets x 1024 steps a window, 4096 slots; the
# bytes a window must move: the candidates' key halves and ranks (20 B) and
# the buffer read and written (12 B a slot each way)
MERGE_CELL = dict(d=5, B=1024, p=0.1, p_sampling=0.25, droplets=4,
                  steps=15625, capacity=4096, timed_window=8)


def _merge_inputs(R, S, kind, n_pool, pool_seed, w):
    """One window of candidates: key halves (R, S, 2) int64, ranks (R, S)
    f32 and a valid mask (R, S) or None, drawn from a pool of ``n_pool``
    chains a row (the same pool every window, so later windows meet chains
    the buffer holds); a chain's rank is a function of the chain."""
    g = torch.Generator(device="cuda").manual_seed(pool_seed)
    halves = torch.randint(0, 2**32, (R, n_pool, 2), generator=g,
                           device="cuda", dtype=torch.int64)
    if kind == "integer":
        rank = torch.randint(0, 21, (R, n_pool), generator=g,
                             device="cuda").float()
    elif kind == "zeros":
        vals = torch.tensor([-0.0, 0.0, 1.0, 2.0], device="cuda")
        rank = vals[torch.randint(0, 4, (R, n_pool), generator=g,
                                  device="cuda")]
    else:
        n = torch.randint(0, 60, (R, n_pool, 3), generator=g, device="cuda")
        b = torch.tensor([1.0986123, 0.70710677, 1.3862944], device="cuda")
        rank = (n[..., 0] * b[0] + n[..., 1] * b[1]) + n[..., 2] * b[2]
        if kind == "dead":
            pick = torch.randint(0, 8, (R, n_pool), generator=g,
                                 device="cuda")
            rank = torch.where(pick == 0, torch.inf, rank)
            rank = torch.where(pick == 1, -torch.inf, rank)
            rank = torch.where(pick == 2, torch.nan, rank)
    g.manual_seed(pool_seed * 1000 + w)
    pick = torch.randint(0, n_pool, (R, S), generator=g, device="cuda")
    valid = None
    if kind == "dead":
        valid = torch.rand((R, S), generator=g, device="cuda") > 0.2
    return (halves.gather(1, pick[..., None].expand(R, S, 2)),
            rank.float().gather(1, pick), valid)


def _plain_merge(key, r, halves, rank, valid):
    """The plain merge as ``streaming_scan`` calls it."""
    R = key.shape[0]
    fk = streaming_mod._pack(halves)
    if valid is not None:
        fk = torch.where(valid, fk, streaming_mod._SENTINEL_KEY)
        rank = torch.where(valid, rank, torch.inf)
    return streaming_mod._merge_row(key, r, fk.reshape(R, -1),
                                    rank.reshape(R, -1))


def _merge_mismatch(kern, plain) -> int:
    """Rows where any of the five outputs differ in any bit."""
    bad = None
    for a, b in zip(kern, plain):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        d = a != b
        d = d.reshape(d.shape[0], -1).any(-1)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def _max_abs_diff(a, b) -> float:
    """The largest absolute difference of two float arrays of one shape, 0
    where they hold the same value (two +inf included)."""
    a, b = (torch.as_tensor(x).cpu().double() for x in (a, b))
    d = (a - b).abs().masked_fill(a == b, 0.0)
    return float(d.max()) if d.numel() else 0.0


def _merge_err(kern, plain) -> float:
    """The largest absolute difference of the buffer's ranks and of
    ``max_kept`` between two merges of one window."""
    return max(_max_abs_diff(kern[1], plain[1]),
               _max_abs_diff(kern[4], plain[4]))


def _force_plain_merge():
    """Context: ``streaming_scan`` takes the plain merge on the card."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        fits = streaming_mod.merge_kernel_fits
        streaming_mod.merge_kernel_fits = lambda C, S: False
        try:
            yield
        finally:
            streaming_mod.merge_kernel_fits = fits

    return ctx()


def _decode_pair(tag, fn, windows):
    """``fn()`` through the merge kernel and through the plain merge: the
    results equal bit for bit, every window merged by the kernel (and none
    by the plain merge) on the first, none on the second."""
    stream_merge_counts.reset()
    kern = fn()
    k_launch, k_plain = (stream_merge_counts.launches,
                         stream_merge_counts.plain_calls)
    stream_merge_counts.reset()
    with _force_plain_merge():
        plain = fn()
    p_launch = stream_merge_counts.launches
    check(k_launch == windows and k_plain == 0,
          f"{tag}: {k_launch} merge launches and {k_plain} plain merges, not "
          f"{windows} and 0")
    check(p_launch == 0, f"{tag}: {p_launch} merge launches on the plain path")
    kern, plain = (np.asarray(x) for x in (kern, plain))
    check(kern.shape == plain.shape and kern.tobytes() == plain.tobytes(),
          f"{tag}: the kernel's decode differs from the plain merge's")
    return f"{tag} equal ({windows} launches)"


def _cell_merge_inputs(spec, m):
    """The STDC cell's decode through the merge kernel and through the
    plain merge, with the stream timing on: ({part: device ms}, windows,
    the same of the plain decode, the inputs of window ``timed_window``,
    the kernel's launches in the decode, the decodes' largest absolute
    difference).  Every window of the kernel's decode is one launch."""
    gen = torch.Generator(device="cuda").manual_seed(2031)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],), device="cuda")
    kw = dict(droplets=m["droplets"], steps=m["steps"], seed=5,
              stream="auto", stream_capacity=m["capacity"], device="cuda")
    seen, win = {}, [0]
    merge = streaming_mod.merge_window

    def capture(key, r, halves, rank, valid):
        if win[0] == m["timed_window"]:
            seen.update(key=key.clone(), r=r.clone(), halves=halves.clone(),
                        rank=rank.clone())
        win[0] += 1
        return merge(key, r, halves, rank, valid)

    stream_timing.enabled = True
    try:
        stream_timing.reset()
        streaming_mod.merge_window = capture
        stream_merge_counts.reset()
        out = STDC(spec, states, m["p"], m["p_sampling"], **kw)
        streaming_mod.merge_window = merge
        split, windows = stream_timing.ms(), stream_timing.windows
        launches, plain_calls = (stream_merge_counts.launches,
                                 stream_merge_counts.plain_calls)
        stream_timing.reset()
        with _force_plain_merge():
            plain = STDC(spec, states, m["p"], m["p_sampling"], **kw)
        split_p, windows_p = stream_timing.ms(), stream_timing.windows
    finally:
        streaming_mod.merge_window = merge
        stream_timing.enabled = False
    check(launches == windows and plain_calls == 0,
          f"the STDC cell's decode: {launches} merge launches and "
          f"{plain_calls} plain merges over {windows} windows")
    out, plain = np.asarray(out), np.asarray(plain)
    check(out.tobytes() == plain.tobytes(),
          "the STDC cell's decode differs between the merge kernel and the "
          "plain merge")
    return (split, windows, split_p, windows_p, seen, launches,
            _max_abs_diff(out, plain))


def phase_stream_merge():
    """The stream merge kernel (csrc/stream_merge.cu) against the plain
    merge (``decoders/streaming.py::_merge_row``), all five outputs bit for
    bit, over MERGE_CASES, each from an empty buffer through windows that
    fill it and overflow it: heavy duplication, integer ranks with many
    ties, dead candidates (+inf, -inf, NaN, an invalid mask), -0.0 beside
    +0.0, C < S and C > S, the cell's partial last window, PTDC's 5120
    candidates, the largest shape ``merge_kernel_fits`` admits.  Then the
    streamed STDC (the cell's window and a partial one, an overflowing
    capacity, conv_mult), STRC, PTDC and PTRC at toric d=5 and STDC at
    toric d=9's default window through the kernel against the plain merge,
    equal bit for bit; the STDC cell's decode both ways with the merge's
    device ms a window; and one merge at the cell's shape (window
    MERGE_CELL["timed_window"]) timed against the plain merge, with its
    share of the card's memory rate and its launch."""
    lines, err = [], 0.0
    for case, (name, R, C, S, kind, n_pool, n_win) in enumerate(MERGE_CASES):
        check(merge_kernel_fits(C, S), f"{name}: C={C} S={S} not admitted")
        key = torch.full((R, C), streaming_mod._SENTINEL_KEY,
                         dtype=torch.int64, device="cuda")
        r = torch.full((R, C), torch.inf, device="cuda")
        stats = []
        for w in range(n_win):
            halves, rank, valid = _merge_inputs(R, S, kind, n_pool,
                                                2030 + case, w)
            kern = merge_window(key, r, halves, rank, valid)
            plain = _plain_merge(key, r, halves, rank, valid)
            torch.cuda.synchronize()
            bad = _merge_mismatch(kern, plain)
            check(bad == 0, f"{name}, window {w}: {bad} of {R} rows differ "
                            f"from the plain merge")
            err = max(err, _merge_err(kern, plain))
            key, r = plain[0], plain[1]
            stats.append(f"{int(plain[2].sum())}/{int(plain[3].sum())}")
        lines.append(f"{name} (R={R} C={C} S={S}; new/overflowed rows a "
                     f"window {' '.join(stats)})")
    print(f"phase 15b merge kernel vs plain merge, all five outputs equal: "
          + "; ".join(lines), flush=True)

    spec5, spec9 = get_spec("toric", 5), get_spec("toric", 9)
    gen = torch.Generator(device="cuda").manual_seed(2032)
    st5 = sample_depolarizing(gen, spec5, 0.1, (256,), device="cuda")
    st9 = sample_depolarizing(gen, spec9, 0.1, (32,), device="cuda")
    kw = dict(droplets=4, steps=3000, seed=7, stream=True, device="cuda")
    decodes = [
        _decode_pair("STDC B=256 4 x 3000 (windows 1024, 1024, 952)",
                     lambda: STDC(spec5, st5, 0.1, 0.25, **kw), 3),
        _decode_pair("STDC capacity 512 (overflowing)",
                     lambda: STDC(spec5, st5, 0.1, 0.25, stream_capacity=512,
                                  **kw), 3),
        _decode_pair("STDC conv_mult=2.0 B=128",
                     lambda: STDC(spec5, st5[:128], 0.1, 0.25, conv_mult=2.0,
                                  **kw), 3),
        _decode_pair("STRC B=256 4 x 3000",
                     lambda: STRC(spec5, st5, 0.1, 0.25, **kw), 3),
        _decode_pair("PTDC B=64 4 droplets x 5 rungs, 3125 steps a rung "
                     "(S=5120)",
                     lambda: PTDC(spec5, st5[:64], 0.1, steps=15625, seed=7,
                                  droplets=4, Nc=5, stream=True,
                                  device="cuda"), 13),
        _decode_pair("PTRC B=64 (S=1024 a rung, C=2048)",
                     lambda: PTRC(spec5, st5[:64], 0.1, steps=15625, seed=7,
                                  droplets=4, Nc=5, stream=True,
                                  device="cuda"), 13),
        _decode_pair("STDC toric d=9 B=32 10 x 20000 (49 windows of 409, "
                     "S=4090)",
                     lambda: STDC(spec9, st9, 0.1, 0.25, droplets=10,
                                  steps=20000, seed=7, stream=True,
                                  device="cuda"), 49),
    ]
    print("phase 15b streamed decodes, merge kernel vs plain merge: "
          + "; ".join(decodes), flush=True)

    m = MERGE_CELL
    (split, windows, split_p, windows_p, seen, launches,
     decode_err) = _cell_merge_inputs(spec5, m)
    key, r, halves, rank = (seen[k] for k in ("key", "r", "halves", "rank"))
    R, C = key.shape
    S = halves[0].numel() // 2
    kern = merge_window(key, r, halves, rank)
    plain = _plain_merge(key, r, halves, rank, None)
    torch.cuda.synchronize()
    bad = _merge_mismatch(kern, plain)
    check(bad == 0, f"the cell's window {m['timed_window']}: {bad} rows "
                    f"differ")
    err = max(err, _merge_err(kern, plain), decode_err)
    ms = _time_ms(lambda: merge_window(key, r, halves, rank), 5)
    plain_ms = _time_ms(lambda: _plain_merge(key, r, halves, rank, None), 3)
    n_bytes = R * S * 20 + 2 * R * C * 12
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 15b the STDC cell (toric d=5 B={m['B']} x 16 classes, "
          f"{m['droplets']} droplets, {m['steps']} steps, capacity "
          f"{m['capacity']}): decode equal both ways, {launches} merge "
          f"launches in {windows} windows; merge device ms a window: kernel "
          f"{split.get('merge', 0.0) / windows:.3f}, plain "
          f"{split_p.get('merge', 0.0) / windows_p:.3f} (sampling "
          f"{split.get('sample', 0.0) / windows:.3f}, {windows} windows); "
          f"window {m['timed_window']} alone (R={R} C={C} S={S}, "
          f"{int(plain[2].sum())} new chains, {int(plain[3].sum())} rows "
          f"overflowed): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"outputs equal; {n_bytes / 1e9:.3f} GB a window, bound "
          f"{bound:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
          f"{100 * bound / ms:.1f}% of the memory rate; largest absolute "
          f"difference of ranks, max_kept and percentages {err!r}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by="bytes", launches=launches)


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
          f"{k1_launch_line(spec, R, True, True)}", flush=True)
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
        out[name] = dict(launches=launches, distr=distr, syn_s=B / dt)
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
          f"{k1_launch_line(spec, R, True, False)}", flush=True)
    launch["launches"] = out["PTDC"]["launches"]
    launch["ptdc_syn_s"] = out["PTDC"]["syn_s"]
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


def _cli_subprocess(*args):
    """``python -m mcmc_qec_tpu_torch <args>`` from the repo root; its
    standard output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "mcmc_qec_tpu_torch", *args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=600)
    check(proc.returncode == 0, f"python -m mcmc_qec_tpu_torch {args[0]} "
          f"exited {proc.returncode}: {proc.stderr[-1500:]}")
    return proc.stdout


def _cli_in_process(*args):
    """``cli.main(args)`` in this process (so its launches count); its
    standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in args])
    check(rc == 0, f"cli {args[0]} returned {rc}")
    return buf.getvalue()


def _recount(ds):
    """(points, failures) of a dataset from its arrays: argmax of the first
    K columns (K = the code's classes) against the stored true classes."""
    K = get_spec(ds.config.code, ds.config.size).n_classes
    return len(ds), int((ds.distributions[:, :K].argmax(1)
                         != ds.true_classes).sum())


def _evaluated(out):
    """{path: failures} from the lines ``evaluate`` prints."""
    got = {}
    for line in out.strip().splitlines():
        m = re.match(r"(.*): (\d+) points, (\d+) failures", line)
        check(m is not None, f"evaluate printed {line!r}")
        got[m.group(1)] = (int(m.group(2)), int(m.group(3)))
    return got


def phase_pipeline(pt_main):
    """The user's entry point on the card: the blossom library's build;
    (a) PTEQ at the production shape through ``python -m
    mcmc_qec_tpu_torch generate`` in a subprocess, its distributions equal
    bit for bit to a direct ``PTEQ`` call on the resampled syndromes and
    the same warm start and seed, its true classes to ``np_eq_class``, and
    in process (after a warm-up) the generate's syn/s, K2 launches and
    host stages against the direct call's; (b) PTDC at the JAX pipeline's
    defaults through the CLI (3125 K1 launches, as phase 18's decode, and
    its syn/s beside phase 18's); (c) planar d=5 through MWPM, eMWPM and
    STDC warm-started by the matcher on one seed, each success rate from
    ``evaluate``, STDC's not below MWPM's by more than two standard
    errors, and the matcher's syndromes/s; (d) ``concat`` and ``evaluate``
    on those files: the counts add up and each failure count equals a
    recount from the arrays."""
    fresh = not Path(native._lib_path()).exists()
    t0 = time.perf_counter()
    native.build_library()
    build_s = time.perf_counter() - t0
    lines = [f"blossom library {'built' if fresh else 'reused'} in "
             f"{build_s:.2f} s"]
    m = PIPE_PTEQ
    spec = get_spec("toric", m["d"])
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.npz") for k in
                 ("pteq", "ptdc", *PIPE_PLANAR["methods"], "cat_toric",
                  "cat_planar")}
        # (a) the CLI in a subprocess
        argv = ["generate", "--code", "toric", "--size", m["d"], "--method",
                "PTEQ", "--p-error", m["p"], "--batch", m["B"], "-n", m["B"],
                "--iters", m["iters"], "--window", m["window"],
                "--max-steps", m["max_steps"], "--seed", m["seed"]]
        t0 = time.perf_counter()
        out = _cli_subprocess(*map(str, argv), "--out", paths["pteq"])
        dt_sub = time.perf_counter() - t0
        check(f"wrote {m['B']} points" in out, f"generate printed {out[-300:]}")
        ds = Dataset.load(paths["pteq"])
        cfg = ds.config
        check(cfg.device == "cuda" and cfg.method == "PTEQ",
              f"dataset config {cfg}")
        states = sample_errors(spec, cfg, error_generator(cfg, 0))
        check(np.array_equal(ds.qubit_matrices.reshape(m["B"], -1), states),
              "the dataset's states are not the resampled syndromes")
        check(np.array_equal(ds.true_classes, np_eq_class(spec, states)),
              "true_classes differ from np_eq_class of the states")
        pcfg = PTEQConfig(Nc=cfg.Nc, SEQ=cfg.SEQ, TOPS=cfg.TOPS, eps=cfg.eps,
                          max_steps=cfg.max_steps, iters=cfg.iters,
                          window=cfg.window, conv_criteria=cfg.conv_criteria)
        check(pcfg.energy_chunk == 4, "the pipeline's energy_chunk moved")
        states_d = torch.as_tensor(states, device="cuda")

        def direct(st, seed):
            g = torch.Generator(device="cuda").manual_seed(seed ^ 0x5EED)
            init = random_logical(spec, st, g)
            return PTEQ(spec, init, cfg.p_error, pcfg, seed=seed,
                        device="cuda")

        # warm-ups at B=64: the direct call and the pipeline
        small = dataclasses.replace(cfg, batch=m["warm_B"], max_steps=1200)
        direct(states_d[: m["warm_B"]], 1)
        generate(None, small, m["warm_B"], progress=None)
        ladder_window_counts.reset()
        res, dt_direct = _sync_time(lambda: direct(states_d, cfg.seed))
        k2_direct = ladder_window_counts.launches
        check(np.array_equal(ds.distributions,
                             res.distribution.astype(np.float32)),
              "the CLI's PTEQ distributions differ from the direct call's")
        # the stages are the recorder's pipeline.* spans, recorded while a
        # profiler (host activity only) records
        profiling.reset()
        ladder_window_counts.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ds_in, dt_gen = _sync_time(lambda: generate(None, cfg, m["B"],
                                                        progress=None))
        stages = {k.split(".", 1)[1]: v["total_ns"] * 1e-9
                  for k, v in profiling.snapshot()["spans"].items()
                  if k.startswith("pipeline.")}
        k2, plain = ladder_window_counts.launches, ladder_window_counts.plain_calls
        check(k2 > 0 and plain == 0, f"generate: {k2} K2 launches, {plain} "
                                     f"plain calls")
        check(k2 == k2_direct, f"generate ran {k2} windows, the direct call "
                               f"{k2_direct}")
        check(np.array_equal(ds_in.distributions, ds.distributions),
              "generate in process differs from the CLI's subprocess")
        host = dt_gen - stages.get("decode", 0.0)
        split = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stages.items())
        res_a = evaluate_dataset(ds)
        lines.append(
            f"(a) PTEQ toric d={m['d']} B={m['B']} p={m['p']} "
            f"iters={m['iters']} window={m['window']} max_steps="
            f"{m['max_steps']} energy_chunk=4 through the CLI subprocess "
            f"({dt_sub:.2f} s with start-up): distributions equal to the "
            f"direct PTEQ call's bit for bit, true classes equal; in process "
            f"generate {m['B'] / dt_gen:.1f} syn/s ({dt_gen:.3f} s, {k2} K2 "
            f"launches, no plain call) against the direct call's "
            f"{m['B'] / dt_direct:.1f} ({dt_direct:.3f} s, {k2_direct}); host "
            f"ms by stage (under a host profiler): {split}; the pipeline "
            f"adds {host * 1e3:.1f} ms; "
            f"success {res_a.success_rate:.4f}")
        # (b) PTDC at the JAX pipeline's defaults through the CLI
        mb = PIPE_PTDC
        sweep_counts.reset()
        out, dt_b = _sync_time(lambda: _cli_in_process(
            "generate", "--device", "cuda", "--code", "toric", "--size",
            mb["d"], "--method", "PTDC", "--p-error", mb["p"], "--batch",
            mb["B"], "-n", mb["B"], "--seed", mb["seed"], "--out",
            paths["ptdc"]))
        k1, plain = sweep_counts.launches, sweep_counts.plain_calls
        check(f"wrote {mb['B']} points" in out, f"generate printed {out[-300:]}")
        check(k1 == pt_main["launches"], f"PTDC through the CLI: {k1} K1 "
              f"launches, phase 18's decode {pt_main['launches']}")
        check(plain == 0, f"PTDC through the CLI: {plain} plain calls")
        ds_b = Dataset.load(paths["ptdc"])
        check(ds_b.config.steps == 5 * mb["d"] ** 5 and ds_b.config.Nc is None
              and ds_b.config.droplets == 4, f"not the defaults: {ds_b.config}")
        res_b = evaluate_dataset(ds_b)
        check(res_b.success_rate >= PT_MAIN["min_recovered"],
              f"PTDC through the CLI: success {res_b.success_rate:.3f}")
        lines.append(
            f"(b) PTDC toric d={mb['d']} B={mb['B']} p={mb['p']} at the "
            f"pipeline's defaults (steps {ds_b.config.steps}, droplets 4, Nc=d) "
            f"through the CLI in process: {mb['B'] / dt_b:.2f} syn/s "
            f"({dt_b:.2f} s, with the dataset's save) against phase 18's "
            f"{pt_main['ptdc_syn_s']:.2f}; {k1} K1 launches (phase 18: "
            f"{pt_main['launches']}), no plain call; success "
            f"{res_b.success_rate:.4f}")
        # (c) planar d=5 on one seed: MWPM, eMWPM, STDC from the matcher
        mc = PIPE_PLANAR
        rates, parts = {}, []
        for method in mc["methods"]:
            extra = ["--mwpm-init", "true"] if method == "STDC" else []
            sweep_counts.reset()
            _, dt_c = _sync_time(lambda: _cli_in_process(
                "generate", "--code", "planar", "--size", mc["d"], "--method",
                method, "--p-error", mc["p"], "--batch", mc["n"], "-n",
                mc["n"], "--seed", mc["seed"], *extra, "--out",
                paths[method]))
            parts.append(f"{method} {mc['n'] / dt_c:.1f} syn/s ({dt_c:.2f} s"
                         + (f", {sweep_counts.launches} K1 launches)"
                            if method == "STDC" else ")"))
            if method == "STDC":
                check(sweep_counts.launches > 0 and sweep_counts.plain_calls
                      == 0, f"STDC: {sweep_counts.launches} K1 launches, "
                      f"{sweep_counts.plain_calls} plain calls")
        got = _evaluated(_cli_in_process("evaluate",
                                          *[paths[k] for k in mc["methods"]]))
        qms = None
        for method in mc["methods"]:
            dsm = Dataset.load(paths[method])
            n, f = got[paths[method]]
            check((n, f) == _recount(dsm), f"evaluate {method}: {(n, f)}, "
                  f"recount {_recount(dsm)}")
            rates[method] = 1.0 - f / n
            if qms is None:
                qms = dsm.qubit_matrices
            check(np.array_equal(dsm.qubit_matrices, qms),
                  f"{method} decoded other syndromes")
        n = mc["n"]
        se = float(np.sqrt(sum(r * (1 - r) / n for r in
                               (rates["STDC"], rates["MWPM"]))))
        check(rates["STDC"] >= rates["MWPM"] - 2 * se,
              f"STDC {rates['STDC']:.4f} below MWPM {rates['MWPM']:.4f} by "
              f"more than 2 se ({se:.4f})")
        pspec = get_spec("planar", mc["d"])
        flat = qms.reshape(n, -1)
        _, dt_m = _sync_time(lambda: class_sorted_mwpm_batch(pspec, flat))
        lines.append(
            f"(c) planar d={mc['d']} p={mc['p']} n={n} one seed: "
            + ", ".join(parts) + "; evaluate: " + ", ".join(
                f"{k} {v:.4f}" for k, v in rates.items())
            + f" (STDC - MWPM {rates['STDC'] - rates['MWPM']:+.4f}, 2 se "
            f"{2 * se:.4f}); matcher warm start (class_sorted_mwpm_batch, "
            f"{os.cpu_count()} host cores) {n / dt_m:.1f} syndromes/s")
        # (d) concat and evaluate
        for name, srcs in (("cat_toric", ("pteq", "ptdc")),
                           ("cat_planar", mc["methods"])):
            out = _cli_in_process("concat", *[paths[k] for k in srcs],
                                  "--out", paths[name])
            total = sum(len(Dataset.load(paths[k])) for k in srcs)
            check(f"wrote {total} points" in out, f"concat printed {out}")
            ev = _evaluated(_cli_in_process("evaluate", paths[name]))
            whole = ev[paths[name]]
            check(whole == _recount(Dataset.load(paths[name])),
                  f"evaluate {name}: {whole}")
            check(whole[1] == sum(_recount(Dataset.load(paths[k]))[1]
                                  for k in srcs),
                  f"{name}: failures do not add up")
        lines.append("(d) concat of (a)+(b) and of (c)'s three: counts add "
                     "up, evaluate equals the recount from the arrays")
    print("phase 21 pipeline and CLI on the card: " + "; ".join(lines),
          flush=True)


def _ckpt_run(ckpt_dir=None):
    """PTEQ at CKPT_MAIN's shape on the card, checkpointing to
    ``ckpt_dir`` (None: off)."""
    m = CKPT_MAIN
    spec = get_spec("toric", m["d"])
    gen = torch.Generator(device="cuda").manual_seed(m["seed"])
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    cfg = PTEQConfig(max_steps=m["max_steps"], window=m["window"],
                     iters=m["iters"], energy_chunk=m["energy_chunk"],
                     ckpt_dir=ckpt_dir, ckpt_every=m["ckpt_every"])
    return PTEQ(spec, states, m["p"], cfg, seed=m["seed"], device="cuda")


def ckpt_worker(ckpt_dir: str) -> int:
    """Phase 22's preempted run: dies with ``os._exit(9)`` right after its
    CKPT_MAIN["kill_after"]-th snapshot lands."""
    orig = CheckpointManager.save
    count = [0]

    def save(self, step, tree, meta=None):
        p = orig(self, step, tree, meta)
        count[0] += 1
        if count[0] >= CKPT_MAIN["kill_after"]:
            print(f"preempted after the snapshot of window {step}", flush=True)
            os._exit(9)
        return p

    CheckpointManager.save = save
    _ckpt_run(ckpt_dir)
    print("the run finished without being preempted", flush=True)
    return 1


def phase_checkpoint():
    """PTEQ at the production shape through K2 with snapshots every 5
    windows: a subprocess killed right after its 2nd snapshot, resumed
    here, equals an uninterrupted run and a run that checkpoints but is
    never killed, bit for bit (distribution, converged, steps, tops0,
    buckets); ms a snapshot and its share of the decode."""
    m = CKPT_MAIN
    fields = ("distribution", "converged", "steps", "tops0")
    base, dt_base = _sync_time(_ckpt_run)
    saves = []
    orig = CheckpointManager.save

    def timed(self, step, tree, meta=None):
        t0 = time.perf_counter()
        p = orig(self, step, tree, meta)
        saves.append(time.perf_counter() - t0)
        return p

    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager.save = timed
        try:
            kept, dt_kept = _sync_time(lambda: _ckpt_run(
                os.path.join(tmp, "kept")))
        finally:
            CheckpointManager.save = orig
        # where a snapshot's time goes: its arrays written again on the
        # host, compressed (as saved) and not
        last = CheckpointManager(os.path.join(tmp, "kept")).latest()
        with np.load(last) as z:
            arrays = {k: z[k] for k in z.files}
        resave = {}
        for name, fn in (("compressed", np.savez_compressed),
                         ("uncompressed", np.savez)):
            t0 = time.perf_counter()
            fn(os.path.join(tmp, name), **arrays)
            resave[name] = (time.perf_counter() - t0,
                            os.path.getsize(os.path.join(tmp, name + ".npz")))
        killed = os.path.join(tmp, "killed")
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--ckpt-worker", killed], capture_output=True,
                              text=True, cwd=ROOT, env=env, timeout=600)
        check(proc.returncode == 9, f"the worker exited {proc.returncode}, "
              f"not 9: {proc.stdout[-500:]} {proc.stderr[-1500:]}")
        snaps = sorted(f for f in os.listdir(killed) if f.startswith("ckpt_"))
        ladder_window_counts.reset()
        resumed, dt_res = _sync_time(lambda: _ckpt_run(killed))
        k2, plain = ladder_window_counts.launches, ladder_window_counts.plain_calls
    check(k2 > 0 and plain == 0, f"resume: {k2} K2 launches, {plain} plain")
    for name, other in (("never-killed", kept), ("resumed", resumed)):
        for f in fields:
            check(np.array_equal(getattr(other, f), getattr(base, f)),
                  f"{name} run: {f} differs from the uninterrupted run")
        check(other.buckets == base.buckets, f"{name} run: buckets differ")
    windows = int(base.steps.max()) // m["window"]
    print(f"phase 22 PTEQ checkpoint kill and resume on the card: toric "
          f"d={m['d']} B={m['B']} p={m['p']} window={m['window']} "
          f"energy_chunk={m['energy_chunk']} ckpt_every={m['ckpt_every']}; "
          f"the worker died after its snapshot {snaps[-1]} "
          f"({proc.stdout.strip().splitlines()[-1]}); resumed {k2} windows "
          f"through K2 ({dt_res:.2f} s); the resumed and the never-killed "
          f"runs equal the uninterrupted one bit for bit (distribution, "
          f"converged, steps, tops0, buckets {list(base.buckets)}, "
          f"{windows} windows); {len(saves)} snapshots at "
          f"{np.mean(saves) * 1e3:.1f} ms each (max {max(saves) * 1e3:.1f}), "
          f"{sum(saves) / dt_kept:.3f} of the checkpointing decode "
          f"({dt_kept:.2f} s against {dt_base:.2f} s without); the last "
          f"snapshot's {sum(a.nbytes for a in arrays.values()) / 1e6:.1f} MB "
          f"of arrays written again on the host: "
          + ", ".join(f"{k} {t * 1e3:.1f} ms ({b / 1e6:.1f} MB on disk)"
                      for k, (t, b) in resave.items()), flush=True)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_worker(argv) -> int:
    """Phase 23's rank: ``python -m mcmc_qec_tpu_torch <argv>`` run in this
    process as ``-m`` runs it (``runpy``), with its ``distributed_generate``
    call wrapped: a warm-up ``generate`` of DIST_WARM points on the rank's
    card first (not counted), then the kernel counts from zero and the
    call's span on the host's clock, printed as one ``RANK {...}`` line."""
    import runpy

    real = parallel.distributed_generate
    rec = {}

    def counted(file_path, cfg, n, progress=None):
        warm = dataclasses.replace(cfg, batch=DIST_WARM, max_steps=1200,
                                   seed=cfg.seed + 10**6)
        generate(None, warm, DIST_WARM, progress=None)
        torch.cuda.synchronize()
        ladder_window_counts.reset()
        sweep_counts.reset()
        rec["start"] = time.time()
        ds = real(file_path, cfg, n, progress)
        torch.cuda.synchronize()
        rec["end"] = time.time()
        rec.update(device=torch.cuda.current_device(),
                   # bytes this rank allocated on each card: its own only
                   peak_by_card=[torch.cuda.max_memory_allocated(i) for i in
                                 range(torch.cuda.device_count())],
                   k2=ladder_window_counts.launches,
                   k2_plain=ladder_window_counts.plain_calls,
                   k1=sweep_counts.launches, k1_plain=sweep_counts.plain_calls)
        return ds

    parallel.distributed_generate = counted
    sys.argv = ["mcmc_qec_tpu_torch", *argv]
    try:
        runpy.run_module("mcmc_qec_tpu_torch", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    print("RANK " + json.dumps(rec), flush=True)
    return rc


def _dist_run(n_ranks, args):
    """``generate --distributed`` in ``n_ranks`` subprocesses (each
    ``chip_smoke.py --rank-worker``) on a free local port, tried once more
    if the port was taken; (the ranks' records, their outputs)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for attempt in range(2):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker",
             "generate", "--distributed", "--coordinator", f"localhost:{port}",
             "--num-processes", str(n_ranks), "--process-id", str(r),
             *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env) for r in range(n_ranks)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt == 0 and any("address already in use" in (o + e).lower()
                                for o, e in outs):
            continue
        for r, (p, (o, e)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                  f"{o[-500:]} {e[-1500:]}")
        recs = [json.loads(next(ln[5:] for ln in o.splitlines()
                                if ln.startswith("RANK ")))
                for o, _ in outs]
        return recs, [o for o, _ in outs]


def _check_merged(ds, parts, what):
    """The merged dataset equals the per-rank runs' concatenation bit for
    bit, and holds no padding row."""
    for f in ("qubit_matrices", "distributions", "true_classes"):
        check(np.array_equal(getattr(ds, f),
                             np.concatenate([getattr(p, f) for p in parts])),
              f"{what}: the merged {f} differ from the per-rank runs'")
    check(bool((ds.true_classes >= 0).all()), f"{what}: a padding row")


def _per_rank(cfg, sizes, counter):
    """In process, rank r's ``generate`` (seed + r) of ``sizes[r]`` points,
    and the launches ``counter`` counted in each."""
    parts, launches = [], []
    for r, n in enumerate(sizes):
        counter.reset()
        parts.append(generate(None, dataclasses.replace(cfg,
                                                        seed=cfg.seed + r),
                              n, progress=None))
        launches.append((counter.launches, counter.plain_calls))
    return parts, launches


def _span(recs):
    return max(r["end"] for r in recs) - min(r["start"] for r in recs)


def phase_multi_device():
    """Multi-device on the card.  (a) PTEQ at the production shape through
    ``python -m mcmc_qec_tpu_torch generate --distributed``, two ranks on
    the card, one batch each: the merged file equals the two ranks'
    ``generate`` runs (seed + r) in process bit for bit, each rank's K2
    launches equal its in-process run's; the merged syn/s over the ranks'
    span against one process's ``generate`` of the same 4096 points.  (b)
    STDC at the bench key's shape, 2047 points over two ranks (1024 +
    1023): the same equalities with K1.  (c) ``dryrun_multichip`` over
    every card (both kernels launch); STDC at (b)'s shape through
    ``map_shards`` over a one-card mesh, equal to the unsharded call, and
    over a mesh that lists the card twice, each shard equal to a direct
    call under seed + i.  (d) ``init_distributed`` with one process, then
    ``distributed_generate`` equal to ``generate``."""
    import contextlib
    import io

    import torch.distributed as dist

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        # (a) PTEQ, two ranks
        m = DIST_PTEQ
        per = m["n"] // m["ranks"]
        path = os.path.join(tmp, "pteq.npz")
        recs, (out0, out1) = _dist_run(m["ranks"], [
            "--code", "toric", "--size", m["d"], "--method", "PTEQ",
            "--p-error", m["p"], "--batch", m["B"], "-n", m["n"], "--iters",
            m["iters"], "--window", m["window"], "--max-steps",
            m["max_steps"], "--seed", m["seed"], "--out", path])
        check(f"wrote {m['n']} points" in out0 and "wrote" not in out1,
              f"rank 0 printed {out0[-300:]!r}, rank 1 {out1[-300:]!r}")
        ds = Dataset.load(path)
        cfg = ds.config
        check(cfg.device == "cuda" and len(ds) == m["n"], f"{cfg}, {len(ds)}")
        parts, direct = _per_rank(cfg, [per] * m["ranks"],
                                  ladder_window_counts)
        _check_merged(ds, parts, "PTEQ")
        k2 = [(r["k2"], r["k2_plain"]) for r in recs]
        check(k2 == direct and all(k > 0 and p == 0 for k, p in k2),
              f"PTEQ ranks' (K2, plain) {k2}, in process {direct}")
        ladder_window_counts.reset()
        _, dt1 = _sync_time(lambda: generate(None, cfg, m["n"], progress=None))
        k2_one = ladder_window_counts.launches
        span = _span(recs)
        each = ", ".join(f"{r['end'] - r['start']:.3f}" for r in recs)
        lines.append(
            f"(a) PTEQ toric d={m['d']} B={m['B']} p={m['p']} -n {m['n']} "
            f"over {m['ranks']} ranks on cards "
            f"{[r['device'] for r in recs]}: merged file equal to the "
            f"per-rank generate runs bit for bit (states, distributions, "
            f"true classes); K2 launches per rank {[k for k, _ in k2]}, no "
            f"plain call; merged {m['n'] / span:.1f} syn/s over the ranks' "
            f"span {span:.3f} s (ranks {each} s) "
            f"against one process's generate {m['n'] / dt1:.1f} syn/s "
            f"({dt1:.3f} s, {k2_one} K2 launches): ratio "
            f"{dt1 / span:.3f}")
        # (b) STDC, two ranks, ragged
        m = DIST_STDC
        path = os.path.join(tmp, "stdc.npz")
        recs, (out0, _) = _dist_run(m["ranks"], [
            "--code", "toric", "--size", m["d"], "--method", "STDC",
            "--p-error", m["p"], "--p-sampling", m["p_sampling"],
            "--droplets", m["droplets"], "--steps", m["steps"], "--batch",
            m["B"], "-n", m["n"], "--seed", m["seed"], "--out", path])
        check(f"wrote {m['n']} points" in out0, f"rank 0 printed {out0[-300:]}")
        ds = Dataset.load(path)
        cfg = ds.config
        sizes = [m["B"], m["n"] - m["B"]]
        check(len(ds) == m["n"], f"STDC merged {len(ds)} points")
        parts, direct = _per_rank(cfg, sizes, sweep_counts)
        _check_merged(ds, parts, "STDC")
        k1 = [(r["k1"], r["k1_plain"]) for r in recs]
        check(k1 == direct and all(k > 0 and p == 0 for k, p in k1),
              f"STDC ranks' (K1, plain) {k1}, in process {direct}")
        _, dt1 = _sync_time(lambda: generate(None, cfg, m["n"], progress=None))
        span = _span(recs)
        lines.append(
            f"(b) STDC toric d={m['d']} B={m['B']} p={m['p']} p_sampling="
            f"{m['p_sampling']} droplets={m['droplets']} steps={m['steps']} "
            f"-n {m['n']} over {m['ranks']} ranks ({sizes[0]} + {sizes[1]}): "
            f"merged file equal to the per-rank runs bit for bit, no padding "
            f"row; K1 launches per rank {[k for k, _ in k1]}, no plain call; "
            f"merged {m['n'] / span:.1f} syn/s over {span:.3f} s against one "
            f"process's {m['n'] / dt1:.1f} ({dt1:.3f} s)")
        # (c) the mesh on the card
        n_cards = torch.cuda.device_count()
        ladder_window_counts.reset()
        sweep_counts.reset()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(n_cards)
        dry = (ladder_window_counts.launches, sweep_counts.launches,
               ladder_window_counts.plain_calls + sweep_counts.plain_calls)
        check(dry[0] == n_cards and dry[1] == n_cards and dry[2] == 0,
              f"dry run: K2 {dry[0]}, K1 {dry[1]} launches, {dry[2]} plain")
        spec = get_spec("toric", m["d"])
        gen = torch.Generator(device="cuda").manual_seed(m["seed"])
        states = sample_depolarizing(gen, spec, m["p"], (m["B"],))

        def decode(shard, seed):
            return STDC(spec, shard, m["p"], m["p_sampling"],
                        droplets=m["droplets"], steps=m["steps"], seed=seed,
                        device=shard.device)

        one = make_mesh(1)
        decode(states, 1)  # warm-up
        got1, dt_one = _sync_time(lambda: map_shards(
            decode, shard_batch(states, one), 7))
        ref, dt_ref = _sync_time(lambda: decode(states, 7))
        check(np.array_equal(got1, ref), "the one-card mesh differs from the "
                                         "unsharded call")
        twice = Mesh((one.devices[0], one.devices[0]))
        sweep_counts.reset()
        got2, dt_two = _sync_time(lambda: map_shards(
            decode, shard_batch(states, twice), 7))
        k1_two = sweep_counts.launches
        half = m["B"] // 2
        in_turn, dt_serial = _sync_time(lambda: [
            decode(states[i * half:(i + 1) * half], 7 + i) for i in range(2)])
        for i in range(2):
            check(np.array_equal(got2[i * half:(i + 1) * half], in_turn[i]),
                  f"shard {i} of the two-entry mesh differs from its direct "
                  f"call under seed + {i}")
        lines.append(
            f"(c) {buf.getvalue().strip()} ({dry[0]} K2 and {dry[1]} K1 "
            f"launches); STDC B={m['B']} over a one-card mesh equal to the "
            f"unsharded call bit for bit ({dt_one * 1e3:.1f} ms against "
            f"{dt_ref * 1e3:.1f}); over the card listed twice each shard "
            f"equal to its direct call under seed + i ({dt_two * 1e3:.1f} ms "
            f"on two threads, {k1_two} K1 launches; the two direct calls in "
            f"turn {dt_serial * 1e3:.1f} ms)")
        # (d) a world of one
        init_distributed(f"localhost:{_free_port()}", 1, 0)
        try:
            small = dataclasses.replace(cfg, seed=m["seed"] + 7)
            ds1 = distributed_generate(os.path.join(tmp, "one.npz"), small,
                                       m["B"], progress=None)
            ref1 = generate(None, small, m["B"], progress=None)
            _check_merged(ds1, [ref1], "world of one")
            check(os.path.exists(os.path.join(tmp, "one.npz")),
                  "the world of one wrote no file")
            world = dist.get_world_size()
        finally:
            dist.destroy_process_group()
        lines.append(f"(d) init_distributed with num_processes=1 (world "
                     f"{world}): distributed_generate of {m['B']} STDC points "
                     f"equal to generate bit for bit")
    print("phase 23 multi-device on the card: " + "; ".join(lines),
          flush=True)


def _committed_cell(name, **key):
    """The record of examples/<name> whose fields equal ``key``."""
    recs = json.loads((ROOT / "examples" / name).read_text())
    return next(r for r in recs if all(r[k] == v for k, v in key.items()))


def _sigmas(f, n, f_ref, n_ref):
    """|f - f_ref| in units of the two binomials' standard deviation."""
    var = (max(f * (1 - f), 1.0 / n) / n
           + max(f_ref * (1 - f_ref), 1.0 / n_ref) / n_ref)
    return abs(f - f_ref) / var ** 0.5


def _k2_name(spec, equal_betas):
    offs = kernel_tables(spec)[2]
    return (f"<{offs['nw']}, {offs['span']}, "
            f"{'true' if equal_betas else 'false'}>")


def _k1_name(spec, equal_betas, record):
    """K1's instantiation for ``spec``: ``<words, spanned words, EQ, REC>``
    of the register kernel, or the large variant's ``wide<EQ, REC>`` with
    the code's word count."""
    offs = kernel_tables(spec)[2]
    flags = (f"{'true' if equal_betas else 'false'}, "
             f"{'true' if record else 'false'}>")
    if kt.is_wide(spec):
        return f"wide<{flags} at {offs['nw']} words"
    return f"<{offs['nw']}, {offs['span']}, {flags}"


def _study_cell(main, argv):
    """One run of a study's main (its stdout kept out of this script's) on
    counts set to 0 just before it: (seconds, K2 launches, K2 plain calls,
    K1 launches, K1 plain calls)."""
    import contextlib
    import io

    ladder_window_counts.reset()
    sweep_counts.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        _, dt = _sync_time(lambda: main(argv))
    return (dt, ladder_window_counts.launches, ladder_window_counts.plain_calls,
            sweep_counts.launches, sweep_counts.plain_calls)


def phase_studies():
    """The studies on the card (mcmc_qec_tpu_torch/studies), each
    through its main: (a) depolarizing ``threshold_fit collect`` at p=0.19,
    toric d=5, 9, 13; (b) ``threshold_fit_biased collect`` at eta=10,
    p=0.275, xzzx d=5 and 13; (c) ``failure_rates`` at toric d=5, p=0.10;
    (d) ``uncorrelated_study`` at planar d=5, p=0.139.  Per cell the failure
    rate beside the committed grid's (within 4 sigma where there is one),
    seconds, syn/s and the kernels' launches with their instantiations
    (every cell must launch its kernel and run no plain version).  Then at
    toric d=13: the window's launch, a direct decode of the study's first
    batch (windows, compaction's batch sizes, ms a window), the host's work
    between points (sampling, one fetch, the truth classes, the JSON
    rewrite), and one production window timed against the plain version
    with its bound."""
    from mcmc_qec_tpu_torch.studies import (failure_rates, threshold_fit,
                                            threshold_fit_biased,
                                            uncorrelated_study)
    from mcmc_qec_tpu_torch.studies.sampling import batch_generator

    lines, fails, k2_d13 = [], [], 0
    with tempfile.TemporaryDirectory() as tmp:
        m = STUDY_DEPOL
        data = os.path.join(tmp, "depol.json")
        for d in m["sizes"]:
            spec = get_spec("toric", d)
            dt, k2, k2p, _, _ = _study_cell(threshold_fit.main, [
                "collect", "--sizes", str(d), "--ps", str(m["p"]), "-n",
                str(m["n"]), "--batch", str(m["n"]), "--cap",
                str(m["caps"][d]), "--data", data, "--device", "cuda"])
            rec = depol_rec = json.loads(Path(data).read_text())[-1]
            ref = _committed_cell("threshold_grid_r4.json", d=d, p=m["p"])
            z = _sigmas(rec["failure_rate"], rec["n"], ref["failure_rate"],
                        ref["n"])
            k2_d13 = k2 if d == 13 else k2_d13
            lines.append(
                f"(a) toric d={d} cap {m['caps'][d]}: failure "
                f"{rec['failure_rate']:.4f} (TPU grid {ref['failure_rate']:.4f}"
                f", {z:.2f} sigma), converged {rec['converged_frac']:.4f}, "
                f"{dt:.2f} s, {m['n'] / dt:.1f} syn/s, K2 "
                f"{_k2_name(spec, True)} {k2} launches")
            if z > STUDY_MAX_SIGMA:
                fails.append(f"depolarizing d={d}: {z:.2f} sigma")
            if k2 == 0 or k2p:
                fails.append(f"depolarizing d={d}: {k2} K2 launches, {k2p} "
                             f"plain calls")
        m = STUDY_BIASED
        data = os.path.join(tmp, "eta.json")
        for d in m["sizes"]:
            spec = get_spec("xzzx", d)
            dt, k2, k2p, _, _ = _study_cell(threshold_fit_biased.main, [
                "collect", "--eta", str(m["eta"]), "--sizes", str(d), "--ps",
                str(m["p"]), "-n", str(m["n"]), "--batch", str(m["n"]),
                "--data", data, "--device", "cuda"])
            rec = json.loads(Path(data).read_text())[-1]
            ref = _committed_cell("threshold_eta10_r5.json", d=d, p=m["p"])
            z = _sigmas(rec["failure_rate"], rec["n"], ref["failure_rate"],
                        ref["n"])
            lines.append(
                f"(b) xzzx d={d} eta={m['eta']} cap {rec['cap']}: failure "
                f"{rec['failure_rate']:.4f} (TPU grid {ref['failure_rate']:.4f}"
                f", {z:.2f} sigma), converged {rec['converged_frac']:.4f}, "
                f"{dt:.2f} s, {m['n'] / dt:.1f} syn/s, K2 "
                f"{_k2_name(spec, False)} {k2} launches")
            if z > STUDY_MAX_SIGMA:
                fails.append(f"biased d={d}: {z:.2f} sigma")
            if k2 == 0 or k2p:
                fails.append(f"biased d={d}: {k2} K2 launches, {k2p} plain "
                             f"calls")
        m = STUDY_FAILURE
        out = os.path.join(tmp, "fr.json")
        spec = get_spec("toric", m["d"])
        dt, _, _, k1, k1p = _study_cell(failure_rates.main, [
            "--sizes", str(m["d"]), "--ps", str(m["p"]), "-n", str(m["n"]),
            "--out", out, "--device", "cuda"])
        rec = json.loads(Path(out).read_text())[0]
        lines.append(
            f"(c) failure_rates toric d={m['d']} p={m['p']} steps "
            f"{rec['steps']} droplets 4 engine sweep: failure "
            f"{rec['failure_rate']:.4f} +- {rec['mc_err']:.4f} (no committed "
            f"counterpart), {dt:.2f} s, {m['n'] / dt:.1f} syn/s, K1 "
            f"{_k1_name(spec, True, True)} {k1} launches")
        if k1 == 0 or k1p:
            fails.append(f"failure_rates: {k1} K1 launches, {k1p} plain calls")
        m = STUDY_UNCORR
        data = os.path.join(tmp, "unc.json")
        spec = get_spec("planar", m["d"])
        dt, _, _, k1, k1p = _study_cell(uncorrelated_study.main, [
            "--sizes", str(m["d"]), "--pk", str(m["pk"]), "-n", str(m["n"]),
            "--outdir", os.path.join(tmp, "unc"), "--data", data, "--fig", "",
            "--device", "cuda"])
        rec = json.loads(Path(data).read_text())[-1]
        ref = _committed_cell("uncorrelated_r5.json", d=m["d"], p=rec["p"])
        parts = []
        for name in ("MWPM", "STDC"):
            z = _sigmas(rec[f"rate_{name}"], rec["n"], ref[f"rate_{name}"],
                        ref["n"])
            parts.append(f"{name} {rec[f'rate_{name}']:.4f} (TPU "
                         f"{ref[f'rate_{name}']:.4f}, {z:.2f} sigma)")
            if z > STUDY_MAX_SIGMA:
                fails.append(f"uncorrelated {name}: {z:.2f} sigma")
        lines.append(
            f"(d) uncorrelated planar d={m['d']} p={rec['p']} steps "
            f"{rec['steps']}: {', '.join(parts)}, {dt:.2f} s, "
            f"{m['n'] / dt:.1f} syn/s, K1 {_k1_name(spec, False, True)} {k1} "
            f"launches")
        if k1 == 0 or k1p:
            fails.append(f"uncorrelated: {k1} K1 launches, {k1p} plain calls")

        # toric d=13: the study's first batch decoded directly
        d, B, p = 13, STUDY_DEPOL["n"], STUDY_DEPOL["p"]
        spec = get_spec("toric", d)
        cfg = threshold_fit.pteq_config(STUDY_DEPOL["caps"][d])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = sample_depolarizing(batch_generator(torch.device("cuda"),
                                                     1000 * 0 + d, p),
                                     spec, p, (B,))
        host = states.cpu().numpy()
        truth = np_eq_class(spec, host)
        t_host = time.perf_counter() - t0
        ladder_window_counts.reset()
        res, dt = _sync_time(lambda: PTEQ(spec, states, p, cfg, seed=1,
                                          device="cuda"))
        windows = ladder_window_counts.launches
        fail = float(np.mean(res.distribution.argmax(-1) != truth))
        recs = [dict(depol_rec, d=5 + i % 5) for i in range(30)]
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "rewrite.json"), "w") as f:
            json.dump(recs, f, indent=1)
        t_json = time.perf_counter() - t0
    r = time_production_window(spec, B, d, p, 24)
    lines.append(
        f"toric d={d} B={B}: launch {launch_line(spec, B, d, True)}; the "
        f"study's first batch decoded directly: {windows} windows, "
        f"{1e3 * dt / max(windows, 1):.2f} ms a window ({dt:.2f} s), batch "
        f"sizes after compaction {list(res.buckets)}, failure {fail:.4f}, "
        f"converged {res.converged.mean():.4f}; host work before the decode "
        f"(sampling, one fetch, truth classes) {1e3 * t_host:.1f} ms, a "
        f"30-record JSON rewrite {1e3 * t_json:.2f} ms; one production "
        f"window: kernel {r['ms']:.3f} ms, plain version "
        f"{r['plain_ms']:.1f} ms, all nine outputs equal, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print("phase 24 studies on the card: " + "; ".join(lines), flush=True)
    check(not fails, "; ".join(fails))
    return dict(r, launches=k2_d13)


def _decode_counts(fn):
    """(fn(), seconds, K2 launches, K2 plain calls, K1 launches, K1 plain
    calls) of one decode on counts set to 0 just before it."""
    ladder_window_counts.reset()
    sweep_counts.reset()
    out, dt = _sync_time(fn)
    return (out, dt, ladder_window_counts.launches,
            ladder_window_counts.plain_calls, sweep_counts.launches,
            sweep_counts.plain_calls)


def time_window(spec, states, Nc, ladder, weights, equal_betas, W, seed):
    """One window of W ladder steps (iters=2, C=12, zero top rung) of the
    kernel against one of the plain version at a decode's shape, from its
    states: outputs equal; (ms, plain ms, err, bound, bound_by)."""
    B = states.shape[0]
    ls = init_ladder(spec, states, Nc)
    eq = torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda")
    sb = torch.zeros((B,), dtype=torch.int32, device="cuda")
    betas = torch.as_tensor(ladder, dtype=torch.float32, device="cuda")
    w = np.asarray(weights, np.float32)
    iters, C = PROD["iters"], PROD["energy_chunk"]
    branch = dict(top_exact=True, equal_betas=equal_betas)
    args = (ls.state, ls.flag, ls.tops0, eq, sb, seed, betas, w)
    kern = make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, **branch)
    kern_out = kern(*args)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: kern(*args), 3)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(ladder_window_reference(
        spec, *args, window=W, iters=iters, p_logical=0.5, tops_burn=2,
        energy_chunk=C, **branch)), 1)
    err = compare_outputs(f"{spec.family} d={spec.size} B={B} W={W}",
                          kern_out, plain_out[0], W, both_swaps=False)
    _, _, n_xblocks = _rng_layout(spec, Nc, iters)
    blocks = (B * Nc * W * iters * philox_blocks_per_sweep(spec)
              + B * W * (_N_EXTRA_USES - 1) * n_xblocks)
    popc = B * Nc * W * iters * popc_per_sweep(spec, equal_betas)
    bound, bound_by = bound_ms(_nbytes(*args[:5], betas, *kern_out), popc,
                               blocks)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)


def phase_large_codes():
    """Codes beyond d=13 on the card (LARGE_* above): (a) K2 and (b) K1
    against their plain versions at the 2-spanned-word and 16-word
    instantiations; (c) decodes through the entry points, only kernels
    running (no plain call), at the bars written in PERF.md before the
    first run, each with its launches, instantiations and one window (or
    sampler launch) timed against the plain version.  Returns the kernel
    line's entries of the decodes and, by (family, d), the PTEQ decodes'
    seconds, K2 launches, windows and form."""
    worst_k2 = 0.0
    names_k2 = set()
    for i, (family, d, Nc, B, W, branch, exchange, traces, rng) in \
            enumerate(LARGE_K2):
        worst_k2 = max(worst_k2, compare_window(
            family, d, Nc, B, W, 2, 4, 0.15, rng, 600 + i, branch, exchange,
            traces=traces, both_swaps=rng == "philox"))
        names_k2.add(_k2_form_name(get_spec(family, d), Nc, BRANCHES[branch][1],
                                   B))
    general = betas_xyz(0.05, 0.02, 0.1)
    worst_k1, n_k1, names_k1 = 0.0, 0, set()
    for i, (family, d, B) in enumerate(LARGE_K1):
        spec = get_spec(family, d)
        for eq in (True, False):
            betas = np.full(3, 0.9) if eq else general
            worst_k1 = max(worst_k1, compare_sweep(family, d, B, 3, betas, eq,
                                                   seed=700 + i))
            worst_k1 = max(worst_k1, compare_sampler(
                family, d, B, 5, 1 if eq else 3, betas, eq, seed=720 + i))
            names_k1 |= {_k1_name(spec, eq, False), _k1_name(spec, eq, True)}
            n_k1 += 2
        worst_k1 = max(worst_k1, compare_per_chain(family, d, B, 2, 2,
                                                   seed=740 + i))
        n_k1 += 1
    lanes = []
    for i, (family, d, R) in enumerate(LARGE_K1_WIDE):
        spec = get_spec(family, d)
        worst_k1 = max(worst_k1, compare_sampler(family, d, R, 2, 1,
                                                 np.full(3, 0.9), True,
                                                 seed=760 + i))
        lanes.append(f"{family} d={d} R={R} at "
                     f"{sw.launch_plan(spec, R, True, True)[0].lanes} lane(s)")
        n_k1 += 1
    fb = LARGE_FALLBACK
    fb_spec = get_spec(fb["family"], fb["d"])
    worst_k1 = max(worst_k1, compare_per_chain(fb["family"], fb["d"],
                                               fb["B"] * fb["d"], 2, 2,
                                               seed=780))
    n_k1 += 1
    print(f"phase 25 (a) window kernel vs plain at codes beyond d=13: "
          f"{len(LARGE_K2)} cases ("
          + "; ".join(f"{f} d={d} Nc={n} B={b} W={w} {br} {ex} traces={tr} {rg}"
                      for f, d, n, b, w, br, ex, tr, rg in LARGE_K2)
          + f"), instantiations {sorted(names_k2)}: all outputs equal, max abs "
          f"err {worst_k2}; (b) sweep kernel vs plain: {n_k1} cases at "
          f"{', '.join(f'{f} d={d} B={b}' for f, d, b in LARGE_K1)} (sweeps "
          f"and recording sampler, equal and general betas; a row of betas "
          f"per chain), {'; '.join(lanes)}, and a row per chain at "
          f"{fb['family']} d={fb['d']} ({fb['B'] * fb['d']} chains), "
          f"instantiations {sorted(names_k1 | {_k1_name(fb_spec, False, False)})}"
          f": all states, keys and counts equal, max abs err {worst_k1}",
          flush=True)
    worst = max(worst_k2, worst_k1)

    lines, fails, entries, decodes = [], [], [], {}

    def kernels_only(tag, k2, k2p, k1, k1p, want_k2, want_k1):
        if k2p or k1p:
            fails.append(f"{tag}: plain calls K2 {k2p}, K1 {k1p}")
        if want_k2 and not k2:
            fails.append(f"{tag}: K2 never launched")
        if want_k1 and not k1:
            fails.append(f"{tag}: K1 never launched")

    # PTEQ_alpha at the biased study's configuration, xzzx d=17
    m = LARGE_ALPHA
    spec = get_spec(m["family"], m["d"])
    px, py, pz = xyz_probs_from_biased(m["p"], m["eta"])
    pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
    gen = torch.Generator(device="cuda").manual_seed(2040)
    states = sample_xyz(gen, spec, px, py, pz, (m["B"],), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())
    cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
    res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ_alpha(
        spec, states, pz_tilde, alpha, cfg, seed=1, device="cuda"))
    kernels_only("PTEQ_alpha xzzx d=17", k2, k2p, k1, k1p, True, False)
    failure = float(np.mean(res.distribution.argmax(-1) != truth))
    if failure > LARGE_MAX_FAILURE:
        fails.append(f"PTEQ_alpha xzzx d=17: failure {failure:.4f} > "
                     f"{LARGE_MAX_FAILURE:.4f}")
    t = time_window(spec, states, m["d"], beta_ladder_alpha(pz_tilde, alpha,
                                                            m["d"]),
                    (alpha, alpha, 1.0), False, LARGE_TIMED_W, 41)
    name = _k2_form_name(spec, m["d"], False, m["B"])
    lines.append(
        f"PTEQ_alpha {m['family']} d={m['d']} Nc={m['d']} eta={m['eta']} "
        f"p={m['p']} B={m['B']} max_steps={m['max_steps']} (window {res.window}): "
        f"{m['B'] / dt:.1f} syn/s ({dt:.2f} s), {k2} windows, K2 {name} {k2} "
        f"launches ({1e3 * dt / max(k2, 1):.1f} ms a window in the decode), "
        f"K1 {k1}, plain 0; failure {failure:.4f} (bar {LARGE_MAX_FAILURE:.4f}),"
        f" converged {res.converged.mean():.4f}; one W={LARGE_TIMED_W} window "
        f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}); launch "
        f"{launch_line(spec, m['B'], m['d'], False)}")
    entries.append(dict(t, name="ladder_window_xzzx_d17", instantiation=name,
                        launches=k2, source="ladder_window.cu"))

    # PTEQ at p=0.05: rotated d=19 and toric d=21
    for i, m in enumerate(LARGE_PTEQ):
        spec = get_spec(m["family"], m["d"])
        gen = torch.Generator(device="cuda").manual_seed(2041 + i)
        states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
        truth = np_eq_class(spec, states.cpu().numpy())
        cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
        fused = lw.window_kernel_fits(spec, m["d"], True, PROD["iters"])
        res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ(
            spec, states, m["p"], cfg, seed=1, device="cuda"))
        tag = f"PTEQ {m['family']} d={m['d']}"
        kernels_only(tag, k2, k2p, k1, k1p, fused, not fused)
        if res.window != ("fused" if fused else "sweep"):
            fails.append(f"{tag}: ran the {res.window} window")
        rec = float(np.mean(res.distribution.argmax(-1) == truth))
        if rec < LARGE_MIN_RECOVERED:
            fails.append(f"{tag}: recovered {rec:.4f} < {LARGE_MIN_RECOVERED}")
        windows = -(-int(res.steps.max()) // PROD["window"])
        form = lw.window_form(spec, m["d"], True, PROD["iters"], m["B"],
                              _n_sm())
        name = (f"K2 {_k2_form_name(spec, m['d'], True, m['B'])} ({form}) {k2} "
                f"launches" if fused else
                f"K1 {_k1_name(spec, False, False)} {k1} launches")
        decodes[(m["family"], m["d"])] = dict(seconds=dt, launches=k2,
                                              windows=windows, form=form,
                                              window=res.window,
                                              recovered=rec)
        t = time_window(spec, states, m["d"],
                        beta_ladder_depolarizing(m["p"], m["d"]),
                        (1.0, 1.0, 1.0), True, LARGE_TIMED_W, 42 + i)
        lines.append(
            f"PTEQ {m['family']} d={m['d']} Nc={m['d']} p={m['p']} "
            f"B={m['B']} max_steps={m['max_steps']} (predicate: "
            f"{'K2 holds the ladder' if fused else 'unfused window'}; ran "
            f"{res.window}): {m['B'] / dt:.1f} syn/s ({dt:.2f} s), {windows} "
            f"windows, {name} ({1e3 * dt / max(windows, 1):.1f} ms a window in "
            f"the decode), other kernel {k1 if fused else k2}, plain 0; "
            f"recovered {rec:.4f} (bar {LARGE_MIN_RECOVERED}), converged "
            f"{res.converged.mean():.4f}, tops0 at the snapshot (min, "
            f"quartiles, max) {np.percentile(res.tops0, [0, 25, 50, 75, 100]).tolist()}, "
            f"buckets {list(res.buckets)}; one "
            f"W={LARGE_TIMED_W} window kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); launch {launch_line(spec, m['B'], m['d'], True)}")
        entries.append(dict(t, name=f"ladder_window_{m['family']}_d{m['d']}",
                            instantiation=_k2_form_name(spec, m["d"], True,
                                                        m["B"]),
                            launches=k2, source="ladder_window.cu"))

    # STDC at rotated d=19 through K1's recording sampler
    m = LARGE_STDC
    spec = get_spec(m["family"], m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2043)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    truth = np_eq_class(spec, states.cpu().numpy())
    distr, dt, k2, k2p, k1, k1p = _decode_counts(lambda: STDC(
        spec, states, m["p"], m["p_sampling"], droplets=m["droplets"],
        steps=m["steps"], engine="auto", device="cuda"))
    kernels_only("STDC rotated d=19", k2, k2p, k1, k1p, False, True)
    rec = float(np.mean(distr.argmax(-1) == truth))
    if rec < LARGE_MIN_RECOVERED:
        fails.append(f"STDC rotated d=19: recovered {rec:.4f} < "
                     f"{LARGE_MIN_RECOVERED}")
    R = m["B"] * spec.n_classes * m["droplets"]
    steps = m["steps"] // 10
    st = _random_states(spec, R, seed=44)
    b = torch.as_tensor(betas_depolarizing(m["p_sampling"]),
                        dtype=torch.float32, device="cuda")
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(44))
    rec_fn = make_recording_sweep(spec, steps, 1, equal_betas=True)
    kern = rec_fn(st, seeds, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: rec_fn(st, seeds, b), 3)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sample_reference(
        spec, st, seeds, b, 1, equal_betas=True)), 1)
    err = compare_outputs_equal(f"sampler rotated d=19 R={R}", kern,
                                plain_out[0], st)
    bound, bound_by = sampler_bound(spec, R, steps, 1, True,
                                    _nbytes(st, seeds, *kern))
    name = _k1_name(spec, True, True)
    lines.append(
        f"STDC {m['family']} d={m['d']} p={m['p']} p_sampling="
        f"{m['p_sampling']} B={m['B']} droplets={m['droplets']} steps="
        f"{m['steps']} engine auto: {m['B'] / dt:.1f} syn/s ({dt:.3f} s), K1 "
        f"{name} {k1} launch(es), K2 {k2}, plain 0; recovered {rec:.4f} (bar "
        f"{LARGE_MIN_RECOVERED}); the sampler at {R} chains x {steps} steps: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
        f"({bound_by}); launch {k1_launch_line(spec, R, True, True)}")
    entries.append(dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                        bound_by=bound_by, name="sweep_sampler_rotated_d19",
                        instantiation=name, launches=k1, source="sweep.cu"))

    # the unfused window asked for by name: xzzx d=31, Nc=31, whose ladder
    # only K2's large variant holds
    m = LARGE_FALLBACK
    spec = fb_spec
    check(lw.window_forms(spec, m["d"], False, PROD["iters"]) == ("large",),
          "xzzx d=31 at 31 rungs is not the large variant's ladder alone")
    gen = torch.Generator(device="cuda").manual_seed(2044)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    cfg = PTEQConfig(max_steps=m["max_steps"], window=m["window"],
                     iters=PROD["iters"], energy_chunk=PROD["energy_chunk"],
                     engine="sweep")
    res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ_alpha(
        spec, states, m["p"], 1.0, cfg, seed=1, device="cuda"))
    kernels_only("PTEQ_alpha xzzx d=31", k2, k2p, k1, k1p, False, True)
    if k2 or res.window != "sweep":
        fails.append(f"xzzx d=31: window {res.window}, {k2} K2 launches")
    Rc = m["B"] * m["d"]
    st = _random_states(spec, Rc, seed=45)
    b = _chain_rows(Rc, m["d"], m["p"], 45)
    fn = make_sweep(spec, PROD["iters"], False)
    kern = fn(st, 45, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: fn(st, 45, b), 20)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sweep_reference(
        spec, st, 45, b, PROD["iters"])), 1)
    n_bad = int((kern != plain_out[0]).sum())
    check(n_bad == 0, f"xzzx d=31 ladder sweep differs in {n_bad} entries")
    bound, bound_by = bound_ms(
        _nbytes(st, b, kern), Rc * PROD["iters"] * popc_per_sweep(spec, False),
        Rc * PROD["iters"] * philox_blocks_per_sweep(spec))
    name = _k1_name(spec, False, False)
    lines.append(
        f"PTEQ_alpha {m['family']} d={m['d']} Nc={m['d']} B={m['B']} "
        f"max_steps={m['max_steps']} window={m['window']} (engine sweep; ran "
        f"{res.window}): {dt:.2f} s, K1 {name} {k1} "
        f"launches ({k1 // m['max_steps']} a ladder step), K2 {k2}, plain 0; "
        f"one ladder step's sweeps at {Rc} chains: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({bound_by})")
    entries.append(dict(ms=ms, plain_ms=plain_ms, err=0.0, bound_ms=bound,
                        bound_by=bound_by, name="sweep_per_chain_xzzx_d31",
                        instantiation=name, launches=k1, source="sweep.cu"))
    print("phase 25 (c) large codes through the entry points: "
          + "; ".join(lines), flush=True)
    check(not fails, "; ".join(fails))
    for e in entries:
        e["err"] = max(e["err"], worst)
    return entries, decodes


class _lanes_per_chain:
    """Run K1 at ``L`` lanes per chain (at least the plan's fewest): the
    plan's choice is replaced while the block runs, in the register form
    and in the large variant (whose warps a block follow from L as the
    plan takes them: parity at every lane count only)."""

    def __init__(self, L):
        self.L = L

    def __enter__(self):
        self.saved = sw.lanes_per_chain, sw.wide_block
        wide = sw.wide_block
        sw.lanes_per_chain = lambda offs, B, n_sm: self.L
        sw.wide_block = lambda spec, record, B, n_sm: wide(spec, record, B, n_sm,
                                                          lanes=self.L)

    def __exit__(self, *exc):
        sw.lanes_per_chain, sw.wide_block = self.saved


def compare_wide(family, d, B, seed):
    """The large variant against its plain versions on the card at every
    lane count the plan allows: ``make_sweep`` (3 sweeps) at equal betas, at
    general betas and at a row of random betas per chain, and
    ``make_recording_sweep`` (5 steps of 2 sweeps) in the same three forms;
    every state, key and count equal.  Returns (cases, lane counts, largest
    absolute difference)."""
    spec = get_spec(family, d)
    check(kt.is_wide(spec), f"{family} d={d} is not above 16 words")
    states = _random_states(spec, B, seed)
    rng = np.random.RandomState(seed)
    forms = [("equal", True, torch.full((3,), 0.9, device="cuda")),
             ("general", False, torch.as_tensor(betas_xyz(0.05, 0.02, 0.1),
                                                dtype=torch.float32, device="cuda")),
             ("per-chain", False, torch.as_tensor(rng.uniform(0.1, 3.0, (B, 3)),
                                                  dtype=torch.float32, device="cuda"))]
    seeds = torch.randint(0, 2**62, (5,), generator=torch.Generator().manual_seed(seed))
    worst, n, lanes = 0.0, 0, []
    for L in (1, 2, 4, 8, 16, 32):
        if L < max(sw.least_lanes(spec, False), sw.least_lanes(spec, True)):
            continue
        lanes.append(L)
        for form, eq, b in forms:
            tag = f"wide {family} d={d} B={B} L={L} {form}"
            with _lanes_per_chain(L):
                kern = make_sweep(spec, 3, eq)(states, seed, b)
                rec = make_recording_sweep(spec, 5, 2, eq)(states, seeds, b)
            plain = sweep_reference(spec, states, seed, b, 3, eq)
            torch.cuda.synchronize()
            n_bad = int((kern != plain).sum())
            check(n_bad == 0, f"{tag}: sweep differs from plain in {n_bad} entries")
            check(not torch.equal(kern, states), f"{tag}: the chains never moved")
            worst = max(worst, float((kern.int() - plain.int()).abs().max()),
                        compare_outputs_equal(tag, rec, sample_reference(
                            spec, states, seeds, b, 2, eq), states))
            n += 2
    return n, lanes, worst


def _wide_sampler_launch(spec, R, steps, equal_betas, seed):
    """One recording launch of the large variant at R chains (the decode's
    sampler shape), timed against the plain sampler on the same inputs:
    outputs equal; (ms, plain ms, err, bound, bound_by)."""
    states = _random_states(spec, R, seed)
    b = (torch.full((3,), 1.7, device="cuda") if equal_betas
         else _chain_rows(R, spec.size, 0.05, seed))
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(seed))
    rec = make_recording_sweep(spec, steps, 1, equal_betas)
    kern = rec(states, seeds, b)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: rec(states, seeds, b), 3)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sample_reference(
        spec, states, seeds, b, 1, equal_betas)), 1)
    err = compare_outputs_equal(f"wide sampler {spec.family} d={spec.size} R={R}",
                                kern, plain_out[0], states)
    bound, bound_by = sampler_bound(spec, R, steps, 1, equal_betas,
                                    _nbytes(states, seeds, b, *kern))
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound,
                bound_by=bound_by)


def _wide_sweep_launch(spec, R, n_sweeps, betas, equal_betas, seed, reps):
    """One ``make_sweep`` launch of the large variant at R chains timed
    against the plain sweep: states equal; (ms, plain ms, err, bound,
    bound_by)."""
    states = _random_states(spec, R, seed)
    fn = make_sweep(spec, n_sweeps, equal_betas)
    kern = fn(states, seed, betas)  # warm-up, kept for the comparison
    ms = _time_ms(lambda: fn(states, seed, betas), reps)
    plain_out = []
    plain_ms = _time_ms(lambda: plain_out.append(sweep_reference(
        spec, states, seed, betas, n_sweeps, equal_betas)), 1)
    n_bad = int((kern != plain_out[0]).sum())
    check(n_bad == 0, f"wide sweep {spec.family} d={spec.size} R={R} differs "
                      f"from plain in {n_bad} entries")
    bound, bound_by = bound_ms(
        _nbytes(states, kern, betas),
        R * n_sweeps * popc_per_sweep(spec, equal_betas),
        R * n_sweeps * philox_blocks_per_sweep(spec))
    return dict(ms=ms, plain_ms=plain_ms, err=0.0, bound_ms=bound,
                bound_by=bound_by)


def phase_codes_above_1024(built):
    """Codes above 1024 qubits on the card (WIDE_* above), through the sweep
    kernel's large variant: (a) parity at 17 to 64 words at every lane
    count, and a ragged last block at the plan's thread count; (b) its
    registers and spills from the build (a spill fails the phase), one
    sweep launch at toric d=45 against its bound; (c) STDC at toric d=25
    and rotated d=45, PTEQ at toric d=23 on the unfused window
    (``engine="sweep"``) and PTDC at toric d=23, only K1 launching, each
    with its launch timed against the bound and the plain version and its
    seconds and launches beside the parent's (WIDE_PARENT).  Returns the
    kernels line's entries and the unfused PTEQ decode's seconds."""
    cases, worst, parts = 0, 0.0, []
    for i, (family, d, B) in enumerate(WIDE_PARITY):
        n, lanes, err = compare_wide(family, d, B, seed=900 + i)
        cases, worst = cases + n, max(worst, err)
        offs = kernel_tables(get_spec(family, d))[2]
        parts.append(f"{family} d={d} ({offs['nw']} words, span {offs['span']}) "
                     f"B={B} at L={lanes}")
    print(f"phase 27 (a) large variant vs plain: {cases} cases ("
          + "; ".join(parts) + "; sweeps and recording sampler, equal, general "
          f"and per-chain betas): all states, keys and counts equal, max abs "
          f"err {worst}", flush=True)

    regs = [ln for ln in ptxas_summary(built["sweep"].log) if "wide" in ln]
    check(not built["sweep"].seconds
          or (regs and all(ln.endswith(" 0 bytes spilled") for ln in regs)),
          f"K1's large variant spills, or its build printed no summary: {regs}")

    def regs_of(name):
        """The ptxas line of ``_k1_name``'s large-variant instantiation."""
        kernel = "sweep_kernel_" + name.split(" at ")[0] + ":"
        return next((ln.split(": ", 1)[1] for ln in regs if ln.startswith(kernel)),
                    "registers not printed (reused build)")
    m = WIDE_TIMED
    spec = get_spec(m["family"], m["d"])
    b = torch.full((3,), 0.9, device="cuda")
    t = _wide_sweep_launch(spec, m["R"], m["n_sweeps"], b, True, 910, 5)
    print(f"phase 27 (b) large variant build: {' | '.join(regs) or 'reused build'}; "
          f"{m['n_sweeps']} sweeps of {m['R']} chains at {m['family']} d={m['d']} "
          f"({_k1_name(spec, True, False)}): kernel {t['ms']:.3f} ms, plain "
          f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}; {popc_per_sweep(spec, True)} popcounts a sweep), "
          f"{t['bound_ms'] / t['ms']:.1%} of the bound; "
          f"{regs_of(_k1_name(spec, True, False))}; launch "
          f"{k1_launch_line(spec, m['R'], False, True)}", flush=True)

    lines, fails, entries = [], [], []

    def kernels_only(tag, k2, k2p, k1, k1p):
        if k2 or k2p or k1p:
            fails.append(f"{tag}: K2 {k2} launches, plain calls K2 {k2p}, K1 {k1p}")
        if not k1:
            fails.append(f"{tag}: K1 never launched")

    for i, m in enumerate(WIDE_STDC):
        spec = get_spec(m["family"], m["d"])
        gen = torch.Generator(device="cuda").manual_seed(2050 + i)
        states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
        truth = np_eq_class(spec, states.cpu().numpy())
        tag = f"STDC {m['family']} d={m['d']}"
        recs = []
        for budget in (WIDE_STDC_FIRST, WIDE_STDC_BUDGET):
            distr, dt, k2, k2p, k1, k1p = _decode_counts(lambda: STDC(
                spec, states, m["p"], m["p_sampling"], engine="auto",
                device="cuda", **budget))
            kernels_only(tag, k2, k2p, k1, k1p)
            recs.append((float(np.mean(distr.argmax(-1) == truth)), dt, k1))
        rec, dt, k1 = recs[-1]
        if rec < WIDE_MIN_RECOVERED:
            fails.append(f"{tag}: recovered {rec:.4f} < {WIDE_MIN_RECOVERED}")
        dr, steps = WIDE_STDC_BUDGET["droplets"], WIDE_STDC_BUDGET["steps"]
        R = m["B"] * spec.n_classes * dr
        if should_stream("auto", m["B"] * spec.n_classes, dr, steps):
            steps = _pick_stream_window(dr, steps)  # one window's launch
        steps //= 10  # the plain sampler takes seconds a hundred steps
        t = _wide_sampler_launch(spec, R, steps, True, 2060 + i)
        name = _k1_name(spec, True, True)
        lines.append(
            f"{tag} p={m['p']} p_sampling={m['p_sampling']} B={m['B']}: at "
            f"{WIDE_STDC_FIRST['droplets']} droplets x {WIDE_STDC_FIRST['steps']} "
            f"steps recovered {recs[0][0]:.4f} ({recs[0][1]:.2f} s, K1 "
            f"{recs[0][2]} launch(es)); at {WIDE_STDC_BUDGET['droplets']} x "
            f"{WIDE_STDC_BUDGET['steps']} recovered {rec:.4f} (bar "
            f"{WIDE_MIN_RECOVERED}), {m['B'] / dt:.1f} syn/s ({dt:.2f} s), K1 "
            f"{name} {k1} launch(es), K2 0, plain 0; one sampler launch at {R} "
            f"chains x {steps} steps: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); {regs_of(name)}; launch "
            f"{k1_launch_line(spec, R, True, True)}")
        parent = WIDE_PARENT[tag]
        lines[-1] += (f"; decode {dt:.2f} s and {k1} K1 launch(es) against the "
                      f"parent's {parent[0]} s and {parent[1]}")
        entries.append(dict(t, name=f"sweep_sampler_wide_{m['family']}_d{m['d']}",
                            instantiation=name, launches=k1, source="sweep.cu"))

    # PTEQ on the unfused window asked for by name (``engine="sweep"``), so
    # that K1's large variant stays on a PTEQ path; phase 28 runs the same
    # decode on K2's large variant
    m = WIDE_PTEQ
    spec = get_spec(m["family"], m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2070)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    cfg = PTEQConfig(max_steps=m["max_steps"], engine="sweep", **PROD)
    res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ(
        spec, states, m["p"], cfg, seed=1, device="cuda"))
    tag = f"PTEQ {m['family']} d={m['d']}"
    kernels_only(tag, k2, k2p, k1, k1p)
    ladder_steps = -(-int(res.steps.max()) // PROD["window"]) * PROD["window"]
    if res.window != "sweep" or k1 != ladder_steps:
        fails.append(f"{tag}: window {res.window}, {k1} K1 launches in "
                     f"{ladder_steps} ladder steps")
    Rc = m["B"] * m["d"]
    b = _chain_rows(Rc, m["d"], m["p"], 2071)
    t = _wide_sweep_launch(spec, Rc, PROD["iters"], b, False, 2071, 20)
    name = _k1_name(spec, False, False)
    unfused_s = dt
    lines.append(
        f"{tag} Nc={m['d']} p={m['p']} B={m['B']} max_steps={m['max_steps']} "
        f"engine sweep (window {res.window}): {dt:.2f} s, K1 {name} {k1} launches in "
        f"{ladder_steps} ladder steps, K2 {k2}, plain 0; converged "
        f"{res.converged.mean():.4f}; one ladder step's sweeps at {Rc} chains: "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}); {regs_of(name)}; launch "
        f"{k1_launch_line(spec, Rc, False, False)}; decode against the "
        f"parent's {WIDE_PARENT[tag][0]} s and {WIDE_PARENT[tag][1]} launches")
    entries.append(dict(t, name="sweep_per_chain_wide_toric_d23",
                        instantiation=name, launches=k1, source="sweep.cu"))

    # PTDC: one recording launch a ladder step
    m = WIDE_PTDC
    spec = get_spec(m["family"], m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2080)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    truth = np_eq_class(spec, states.cpu().numpy())
    distr, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTDC(
        spec, states, m["p"], droplets=m["droplets"], steps=m["steps"],
        device="cuda"))
    tag = f"PTDC {m['family']} d={m['d']}"
    kernels_only(tag, k2, k2p, k1, k1p)
    ladder_steps = m["steps"] // m["d"]
    if k1 != ladder_steps:
        fails.append(f"{tag}: {k1} K1 launches in {ladder_steps} ladder steps")
    R = m["B"] * spec.n_classes * m["droplets"] * m["d"]
    t = _wide_sampler_launch(spec, R, 1, False, 2081)
    name = _k1_name(spec, False, True)
    lines.append(
        f"{tag} Nc={m['d']} p={m['p']} B={m['B']} droplets={m['droplets']} "
        f"steps={m['steps']}: {dt:.2f} s, K1 {name} {k1} launches in "
        f"{ladder_steps} ladder steps, K2 {k2}, plain 0; recovered "
        f"{float(np.mean(distr.argmax(-1) == truth)):.4f}; one ladder-step "
        f"launch at {R} chains: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
        f"{regs_of(name)}; launch {k1_launch_line(spec, R, True, False)}; "
        f"decode against the "
        f"parent's {WIDE_PARENT[tag][0]} s and {WIDE_PARENT[tag][1]} launches")
    entries.append(dict(t, name="sweep_ladder_step_wide_toric_d23",
                        instantiation=name, launches=k1, source="sweep.cu"))
    print("phase 27 (c) codes above 1024 qubits through the entry points: "
          + "; ".join(lines), flush=True)
    check(not fails, "; ".join(fails))
    for e in entries:
        e["err"] = max(e["err"], worst)
    return entries, unfused_s


def _k2_wide_name(spec, equal_betas):
    """K2's large-variant instantiation ``wide<EQ>`` with the code's word
    count."""
    offs = kernel_tables(spec)[2]
    return f"wide<{'true' if equal_betas else 'false'}> at {offs['nw']} words"


def _n_sm() -> int:
    """The card's SMs, which ``window_form`` counts waves over."""
    return kt._sm_count(torch.device("cuda"))


def _k2_form_name(spec, Nc, equal_betas, B):
    """The K2 instantiation ``window_form`` picks for Nc rungs of ``spec``
    over B rows at PROD's sweeps a step."""
    if lw.window_form(spec, Nc, equal_betas, PROD["iters"], B,
                      _n_sm()) == "large":
        return _k2_wide_name(spec, equal_betas)
    return _k2_name(spec, equal_betas)


class _window_form:
    """Run K2 in ``form`` where that form is built and holds the ladder
    (parity only): ``window_form``'s choice is replaced while the block
    runs; None keeps it."""

    def __init__(self, form):
        self.form = form

    def __enter__(self):
        self.saved = lw.window_form
        if self.form is not None:
            lw.window_form = lambda *args: self.form

    def __exit__(self, *exc):
        lw.window_form = self.saved


def phase_window_above_16_words(built, unfused_s):
    """K2's large variant on the card (WIDE_K2* above): (a) every output
    equal to the plain version's in every branch, mode and draw form at
    17 to 23 words and at xzzx d=31's 31 rungs (16 words); (b) its
    registers and spills from the build; (c) PTEQ at toric d=23 (one K2
    launch a window, no K1) against phase 27's unfused decode
    (``unfused_s`` seconds) and PTEQ_alpha at xzzx d=33; (d) PTEQ at
    toric d=25, B=128, and one window against its bound and the plain
    version.  Returns the kernels line's entries."""
    worst, names = 0.0, set()
    for i, (family, d, Nc, B, W, branch, exchange, traces, rng, lanes) in \
            enumerate(WIDE_K2):
        spec = get_spec(family, d)
        eq = BRANCHES[branch][1]
        check(lw.window_form(spec, Nc, eq, 2, B, _n_sm()) == "large",
              f"{family} d={d} Nc={Nc}: not the large variant's ladder")
        worst = max(worst, compare_window(
            family, d, Nc, B, W, 2, 4, 0.15, rng, 1300 + i, branch, exchange,
            traces=traces, both_swaps=rng == "philox", lanes=lanes))
        names.add(_k2_wide_name(spec, eq))
    print(f"phase 28 (a) window kernel's large variant vs plain: "
          f"{len(WIDE_K2)} cases ("
          + "; ".join(f"{f} d={d} Nc={n} B={b} W={w} {br} {ex} traces={tr} "
                      f"{rg} lanes={ln or 'plan'}"
                      for f, d, n, b, w, br, ex, tr, rg, ln in WIDE_K2)
          + f"), instantiations {sorted(names)}: all outputs equal, max abs "
          f"err {worst}", flush=True)

    regs = [ln for ln in ptxas_summary(built["ladder_window"].log) if "wide" in ln]
    print(f"phase 28 (b) large variant build: "
          f"{' | '.join(regs) or 'reused build'}", flush=True)

    lines, fails, entries = [], [], []

    def kernels_only(tag, k2, k2p, k1, k1p):
        if k1 or k2p or k1p:
            fails.append(f"{tag}: K1 {k1} launches, plain calls K2 {k2p}, K1 {k1p}")
        if not k2:
            fails.append(f"{tag}: K2 never launched")

    def pteq_at(m, seed, tag):
        spec = get_spec(m["family"], m["d"])
        gen = torch.Generator(device="cuda").manual_seed(seed)
        states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
        cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
        res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ(
            spec, states, m["p"], cfg, seed=1, device="cuda"))
        kernels_only(tag, k2, k2p, k1, k1p)
        windows = -(-int(res.steps.max()) // PROD["window"])
        if res.window != "fused" or k2 != windows:
            fails.append(f"{tag}: window {res.window}, {k2} K2 launches in "
                         f"{windows} windows")
        t = time_window(spec, states, m["d"],
                        beta_ladder_depolarizing(m["p"], m["d"]),
                        (1.0, 1.0, 1.0), True, LARGE_TIMED_W, seed)
        return spec, states, res, dt, k2, windows, t

    # (c) PTEQ at toric d=23, the decode phase 27 runs on the unfused window
    m = WIDE_PTEQ
    tag = f"PTEQ {m['family']} d={m['d']}"
    spec, _, res, dt, k2, windows, t = pteq_at(m, 2070, tag)
    name = _k2_wide_name(spec, True)
    lines.append(
        f"{tag} Nc={m['d']} p={m['p']} B={m['B']} max_steps={m['max_steps']} "
        f"(window {res.window}): {dt:.2f} s against {unfused_s:.2f} s unfused "
        f"(phase 27, this call; {unfused_s / dt:.1f}x), K2 {name} {k2} "
        f"launches in {windows} windows, K1 0, plain 0; converged "
        f"{res.converged.mean():.4f}; one W={LARGE_TIMED_W} window kernel "
        f"{t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}); launch "
        f"{launch_line(spec, m['B'], m['d'], True)}")
    entries.append(dict(t, name="ladder_window_wide_toric_d23",
                        instantiation=name, launches=k2,
                        source="ladder_window.cu"))

    # PTEQ_alpha at the biased study's cell on xzzx d=33, capped steps
    m = WIDE_K2_ALPHA
    spec = get_spec(m["family"], m["d"])
    px, py, pz = xyz_probs_from_biased(m["p"], m["eta"])
    pz_tilde, alpha = biased_alpha_equivalent(m["p"], m["eta"])
    gen = torch.Generator(device="cuda").manual_seed(2090)
    states = sample_xyz(gen, spec, px, py, pz, (m["B"],), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())
    cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
    res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ_alpha(
        spec, states, pz_tilde, alpha, cfg, seed=1, device="cuda"))
    tag = f"PTEQ_alpha {m['family']} d={m['d']}"
    kernels_only(tag, k2, k2p, k1, k1p)
    failure = float(np.mean(res.distribution.argmax(-1) != truth))
    if failure > LARGE_MAX_FAILURE:
        fails.append(f"{tag}: failure {failure:.4f} > {LARGE_MAX_FAILURE:.4f}")
    if res.window != "fused":
        fails.append(f"{tag}: ran the {res.window} window")
    t = time_window(spec, states, m["d"], beta_ladder_alpha(pz_tilde, alpha,
                                                            m["d"]),
                    (alpha, alpha, 1.0), False, LARGE_TIMED_W, 2091)
    name = _k2_wide_name(spec, False)
    lines.append(
        f"{tag} Nc={m['d']} eta={m['eta']} p={m['p']} B={m['B']} max_steps="
        f"{m['max_steps']} (window {res.window}): {m['B'] / dt:.1f} syn/s "
        f"({dt:.2f} s), K2 {name} {k2} launches, K1 0, plain 0; failure "
        f"{failure:.4f} (bar {LARGE_MAX_FAILURE:.4f}), converged "
        f"{res.converged.mean():.4f}; one W={LARGE_TIMED_W} window kernel "
        f"{t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}); launch "
        f"{launch_line(spec, m['B'], m['d'], False)}")
    entries.append(dict(t, name="ladder_window_wide_xzzx_d33",
                        instantiation=name, launches=k2,
                        source="ladder_window.cu"))
    print("phase 28 (c) the large variant through the entry points: "
          + "; ".join(lines), flush=True)

    # (d) toric d=25 at B=128: the decode, one window against its bound
    # and the plain version, and a production window's ms
    m = WIDE_K2_TIMED
    tag = f"PTEQ {m['family']} d={m['d']}"
    spec, states, res, dt, k2, windows, t = pteq_at(m, 2092, tag)
    ls = init_ladder(spec, states, m["d"])
    zeros = (torch.zeros((m["B"], spec.n_classes), dtype=torch.int32, device="cuda"),
             torch.zeros((m["B"],), dtype=torch.int32, device="cuda"))
    prod = make_ladder_window(spec, m["d"], PROD["window"], PROD["iters"], 0.5,
                              2, PROD["energy_chunk"], **PROD_BRANCH)
    betas = torch.as_tensor(beta_ladder_depolarizing(m["p"], m["d"]),
                            dtype=torch.float32, device="cuda")
    args = (ls.state, ls.flag, ls.tops0, *zeros, 3, betas, np.ones(3, np.float32))
    prod(*args)
    prod_ms = _time_ms(lambda: prod(*args), 3)
    name = _k2_wide_name(spec, True)
    print(f"phase 28 (d) {tag} Nc={m['d']} p={m['p']} B={m['B']} max_steps="
          f"{m['max_steps']}: {dt:.2f} s, K2 {name} {k2} launches in {windows} "
          f"windows; one W={LARGE_TIMED_W} window kernel {t['ms']:.3f} ms, "
          f"plain {t['plain_ms']:.1f} ms ({t['plain_ms'] / t['ms']:.1f}x), bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"{t['bound_ms'] / t['ms']:.1%} of the bound; a W={PROD['window']} "
          f"window {prod_ms:.3f} ms; launch "
          f"{launch_line(spec, m['B'], m['d'], True)}", flush=True)
    entries.append(dict(t, name="ladder_window_wide_toric_d25",
                        instantiation=name, launches=k2,
                        source="ladder_window.cu"))

    check(not fails, "; ".join(fails))
    for e in entries:
        e["err"] = max(e["err"], worst)
    return entries


def phase_window_forms(built, decodes, wide_k2):
    """The redesigned large variant on the card (FORMS_K2, WIDE_K2_BATCH
    above): (a) at the 12- and 16-word codes, which have no register build
    and where ``window_form`` picks it, every output equal to the plain
    version's; its registers and spills; (b)
    phase 25's PTEQ at toric d=21 (``decodes``): form, launches, seconds;
    (c) W=60 windows against their bounds, phase 28's (``wide_k2``) and
    one of a PTEQ decode at toric d=25 B=1024.  Returns the kernels line's
    entries."""
    worst, names = 0.0, set()
    for i, (family, d, Nc, B, W, branch, exchange, traces, rng, lanes) in \
            enumerate(FORMS_K2):
        spec = get_spec(family, d)
        eq = BRANCHES[branch][1]
        check(lw.window_form(spec, Nc, eq, PROD["iters"], B, _n_sm()) == "large",
              f"{family} d={d} Nc={Nc}: window_form does not pick the large "
              f"variant")
        worst = max(worst, compare_window(
            family, d, Nc, B, W, 2, 4, 0.15, rng, 2900 + i, branch, exchange,
            traces=traces, both_swaps=rng == "philox", lanes=lanes))
        names.add(_k2_wide_name(spec, eq))
    regs = [ln for ln in ptxas_summary(built["ladder_window"].log) if "wide" in ln]
    check(not built["ladder_window"].seconds
          or (regs and all(ln.endswith(" 0 bytes spilled") for ln in regs)),
          f"the large variant spills, or its build printed no summary: {regs}")
    print(f"phase 29 (a) large variant vs plain at 12 and 16 words: "
          f"{len(FORMS_K2)} cases ("
          + "; ".join(f"{f} d={d} Nc={n} B={b} W={w} {br} {ex} traces={tr} "
                      f"{rg} lanes={ln or 'plan'}"
                      for f, d, n, b, w, br, ex, tr, rg, ln in FORMS_K2)
          + f"), {sorted(names)}: all outputs equal, max abs err {worst}; "
          f"large variant build: {' | '.join(regs) or 'reused build'}",
          flush=True)

    d21 = decodes[("toric", 21)]
    m = LARGE_PTEQ[1]
    check(d21["form"] == "large" and d21["window"] == "fused"
          and d21["launches"] == d21["windows"],
          f"toric d=21: form {d21['form']}, window {d21['window']}, "
          f"{d21['launches']} K2 launches in {d21['windows']} windows")
    print(f"phase 29 (b) phase 25's PTEQ toric d=21 B={m['B']} p={m['p']} "
          f"max_steps={m['max_steps']}: form {d21['form']} "
          f"({_k2_wide_name(get_spec('toric', 21), True)}), {d21['launches']} "
          f"K2 launches in {d21['windows']} windows, {d21['seconds']:.2f} s, "
          f"recovered {d21['recovered']:.4f}", flush=True)

    m = WIDE_K2_BATCH
    spec = get_spec(m["family"], m["d"])
    gen = torch.Generator(device="cuda").manual_seed(2094)
    states = sample_depolarizing(gen, spec, m["p"], (m["B"],))
    cfg = PTEQConfig(max_steps=m["max_steps"], **PROD)
    res, dt, k2, k2p, k1, k1p = _decode_counts(lambda: PTEQ(
        spec, states, m["p"], cfg, seed=1, device="cuda"))
    check(k2 >= 1 and not (k2p or k1 or k1p) and res.window == "fused",
          f"toric d=25 B={m['B']}: {k2} K2 launches, plain {k2p}, K1 {k1}, "
          f"{k1p}, window {res.window}")
    t = time_window(spec, states, m["d"], beta_ladder_depolarizing(m["p"], m["d"]),
                    (1.0, 1.0, 1.0), True, LARGE_TIMED_W, 2095)
    entry = dict(t, name="ladder_window_wide_toric_d25_b1024",
                 instantiation=_k2_wide_name(spec, True), launches=k2,
                 source="ladder_window.cu")
    timed = {e["name"]: e for e in wide_k2}
    shapes = (("toric d=23 B=16", timed["ladder_window_wide_toric_d23"]),
              ("xzzx d=33 B=64", timed["ladder_window_wide_xzzx_d33"]),
              ("toric d=25 B=128", timed["ladder_window_wide_toric_d25"]),
              (f"toric d=25 B={m['B']}", entry))
    print(f"phase 29 (c) W={LARGE_TIMED_W} windows of the large variant "
          f"against their bounds: "
          + "; ".join(f"{what} {e['ms']:.3f} ms, bound {e['bound_ms']:.4f} ms "
                      f"({e['bound_by']}), {e['bound_ms'] / e['ms']:.1%} of it, "
                      f"plain {e['plain_ms']:.1f} ms" for what, e in shapes)
          + f"; PTEQ toric d=25 B={m['B']} max_steps={m['max_steps']}: "
          f"{dt:.2f} s, {k2} K2 launch(es); launch "
          f"{launch_line(spec, m['B'], m['d'], True)}", flush=True)
    entry["err"] = max(entry["err"], worst)
    return [entry]


def phase_alpha_cell():
    """The benchmark's biased-noise cell on the card (ALPHA_CELL above): one
    request at the cell's configuration through ``PTEQ_alpha`` under the
    recorder, every K2 launch the large variant with per-Pauli betas and
    512 rows; then one window at each batch of ALPHA_CELL's, in the form
    and lanes ``window_form`` and ``window_lanes`` pick there, on the
    cell's ladder and weights, every output equal to the plain version's."""
    m = ALPHA_CELL
    cell = json.loads((ROOT / "port_bench" / "configs"
                       / f"{m['config']}.json").read_text())
    traffic = json.loads((ROOT / "port_bench" / "traffic"
                          / f"{m['traffic']}.json").read_text())
    code, dec = cell["code"], cell["decoder"]
    spec = get_spec(code["family"], code["size"])
    p, eta, B = traffic["p"], traffic["eta"], traffic["batch"]
    px, py, pz = xyz_probs_from_biased(p, eta)
    pz_tilde, alpha = biased_alpha_equivalent(p, eta)
    fields = {f.name for f in dataclasses.fields(PTEQConfig)}
    cfg = PTEQConfig(**{k: v for k, v in dec.items() if k in fields})
    Nc = cfg.Nc
    gen = torch.Generator(device="cuda").manual_seed(m["seed"])
    states = sample_xyz(gen, spec, px, py, pz, (B,), device="cuda")
    truth = np_eq_class(spec, states.cpu().numpy())

    def decode():
        return PTEQ_alpha(spec, states, pz_tilde, alpha, cfg, seed=1,
                          device="cuda")

    decode()  # builds or loads K2
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res, dt, k2, k2p, k1, k1p = _decode_counts(decode)
    c = profiling.snapshot()["counters"]
    profiling.reset()
    cap = cfg.max_steps // cfg.window
    check(k2 >= 1 and not (k2p or k1 or k1p) and res.window == "fused",
          f"{k2} K2 launches, plain {k2p}, K1 {k1}, {k1p}, window "
          f"{res.window}")
    check(c.get("k2.betas.general") == k2,
          f"k2.betas.general {c.get('k2.betas.general')} in {k2} launches")
    rows = {f: c.get(f"k2.rows.{f}", 0) for f in ("large", "registers")}
    forms = {f: c.get(f"k2.form.{f}", 0) for f in ("large", "registers")}
    check(sum(forms.values()) == k2, f"forms {forms} in {k2} launches")
    check(rows["large"] >= B and forms["large"] >= 1,
          f"the batch of {B} did not run the large variant: {forms}, {rows}")
    failure = float(np.mean(res.distribution.argmax(-1) != truth))
    lines = [f"{code['family']} d={code['size']} Nc={Nc} eta={eta} p={p} "
             f"(pz_tilde={pz_tilde:.6f}, alpha={alpha:.6f}) B={B} "
             f"max_steps={cfg.max_steps} eps={cfg.eps} iters={cfg.iters}: "
             f"{dt:.2f} s, {B / dt:.1f} syn/s, {k2} K2 launches (cap {cap}), "
             f"forms {forms}, rows {rows}, lanes "
             f"{ {k: v for k, v in c.items() if k.startswith('k2.lanes.')} }, "
             f"k2.betas.general {c['k2.betas.general']}, batch sizes after "
             f"compaction {list(res.buckets)}, converged "
             f"{res.converged.mean():.4f}, failure {failure:.4f}"]

    ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
    betas = torch.as_tensor(ladder, dtype=torch.float32, device="cuda")
    w = np.asarray((alpha, alpha, 1.0), np.float32)
    branch = dict(top_exact=True, equal_betas=False)
    W, worst = m["W"], 0.0
    for i, (rows_b, form, lanes) in enumerate(m["windows"]):
        check(lw.window_form(spec, Nc, False, cfg.iters, rows_b, _n_sm())
              == form, f"{rows_b} rows: window_form does not pick {form}")
        if lanes is not None:
            check(lw.window_lanes(spec, Nc, False, cfg.iters, rows_b, _n_sm())
                  == lanes, f"{rows_b} rows: window_lanes is not {lanes}")
        inputs = _ladder_inputs(spec, rows_b, Nc, 3000 + i, "cuda")
        args = (*inputs, 4100 + i, betas, w)
        kern = make_ladder_window(spec, Nc, W, cfg.iters, cfg.p_logical,
                                  cfg.tops_burn, cfg.energy_chunk,
                                  **branch)(*args)
        plain = ladder_window_reference(
            spec, *args, window=W, iters=cfg.iters, p_logical=cfg.p_logical,
            tops_burn=cfg.tops_burn, energy_chunk=cfg.energy_chunk, **branch)
        worst = max(worst, compare_outputs(
            f"{m['config']} window of {rows_b} rows ({form})", kern, plain, W))
        name = (_k2_wide_name(spec, False) if form == "large"
                else _k2_name(spec, False))
        lines.append(f"{rows_b} rows: {name} ({form}, lanes "
                     f"{lanes or 'plan'}), W={W}, all outputs equal to the "
                     f"plain version")
    print("phase 30 the benchmark's biased-noise cell: " + "; ".join(lines)
          + f"; max abs err {worst}", flush=True)


def phase_golden():
    """The golden-corpus studies on the card (GOLDEN above), each through
    its ``run`` on syndromes drawn here, so without pandas: golden_replay
    with PTEQ at its production configuration (K2) and with STDC at engine
    "auto" (K1), and golden_ceiling at cap 32000 with its MWPM row.  Each
    must launch its kernel and run no plain version."""
    import contextlib
    import io

    from mcmc_qec_tpu_torch.studies import golden_ceiling, golden_replay

    m = GOLDEN
    spec = get_spec("toric", m["d"])
    gen = torch.Generator(device="cuda").manual_seed(m["seed"])
    flat = sample_depolarizing(gen, spec, m["p"], (m["n"],)).cpu().numpy()
    trues = np_eq_class(spec, flat)
    runs = [
        ("golden_replay --decoder PTEQ", "K2", lambda: golden_replay.run(
            spec, flat, trues, "PTEQ", m["n"], device="cuda")),
        ("golden_replay --decoder STDC --engine auto", "K1",
         lambda: golden_replay.run(spec, flat, trues, "STDC", m["n"],
                                   engine="auto", device="cuda")),
        (f"golden_ceiling --limit {m['n']} --cap {m['cap']}", "K2",
         lambda: golden_ceiling.run(spec, flat, trues, cap=m["cap"],
                                    device="cuda")),
    ]
    lines, fails = [], []
    for tag, kernel, fn in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, dt, k2, k2p, k1, k1p = _decode_counts(fn)
        launches = k2 if kernel == "K2" else k1
        if not launches or k2p or k1p:
            fails.append(f"{tag}: {kernel} {launches} launches, plain calls "
                         f"{k2p + k1p}")
        lines.append(f"{tag}: {' | '.join(buf.getvalue().strip().splitlines())}"
                     f" [{dt:.2f} s; K2 {_k2_name(spec, True)} {k2} launches, "
                     f"K1 {_k1_name(spec, True, True)} {k1}, plain 0]")
    print(f"phase 26 golden studies on the card, on {m['n']} toric d={m['d']} "
          f"syndromes drawn here at p={m['p']} (not the DRL failure set, so "
          f"the recovery is not RESULTS.md's figure): " + "; ".join(lines),
          flush=True)
    check(not fails, "; ".join(fails))


def main() -> int:
    phase = "device"
    try:
        phase_device()
        phase = "build"
        built = phase_build()
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
        phase = "stream merge kernel vs plain merge"
        merge = phase_stream_merge()
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
        phase = "pipeline and CLI on the card"
        phase_pipeline(k1_pt)
        phase = "PTEQ checkpoint kill and resume on the card"
        phase_checkpoint()
        phase = "multi-device on the card"
        phase_multi_device()
        phase = "threshold studies on the card"
        k2_study = phase_studies()
        phase = "large codes on the card"
        large, decodes = phase_large_codes()
        phase = "golden studies on the card"
        phase_golden()
        phase = "codes above 1024 qubits on the card"
        wide, unfused_s = phase_codes_above_1024(built)
        phase = "the window kernel above 16 words"
        wide_k2 = phase_window_above_16_words(built, unfused_s)
        phase = "the redesigned large variant and the choice of form"
        forms = phase_window_forms(built, decodes, wide_k2)
        phase = "the benchmark's biased-noise cell"
        phase_alpha_cell()
    except PhaseFailed as e:
        print(f"FAILED phase {phase}: {e}", flush=True)
        return 1
    k1_main = k1[1]
    toric = {d: get_spec("toric", d) for d in (5, 9, 13)}
    print(json.dumps({"kernels": [{
        "name": "ladder_window",
        "instantiation": _k2_name(toric[5], True),
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
        "instantiation": _k1_name(toric[5], True, False),
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
        "instantiation": _k1_name(toric[5], True, True),
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
        "instantiation": _k1_name(toric[9], True, True),
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
        "instantiation": _k1_name(toric[5], False, True),
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
        "instantiation": _k2_name(get_spec("xzzx", BIASED_MAIN["d"]), False),
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
    }, {
        "name": "ladder_window_study",
        "instantiation": _k2_name(toric[13], True),
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/ladder_window.cu",
        "replaces": "mcmc_qec_tpu/ops/pallas_ladder.py:144",
        "launches": k2_study["launches"],
        "max_abs_err": k2_study["err"],
        "ms": k2_study["ms"],
        "plain_ms": k2_study["plain_ms"],
        "bound_ms": k2_study["bound_ms"],
        "bound_by": k2_study["bound_by"],
        "library_ms": None,
    }, {
        "name": "stream_merge",
        "instantiation": "stream_merge_kernel<512>",
        "route": "cuda",
        "source": "mcmc_qec_tpu_torch/csrc/stream_merge.cu",
        "replaces": None,
        "launches": merge["launches"],
        "max_abs_err": merge["err"],
        "ms": merge["ms"],
        "plain_ms": merge["plain_ms"],
        "bound_ms": merge["bound_ms"],
        "bound_by": merge["bound_by"],
        "library_ms": None,
    }] + [{
        "name": e["name"],
        "instantiation": e["instantiation"],
        "route": "cuda",
        "source": f"mcmc_qec_tpu_torch/csrc/{e['source']}",
        "replaces": ("mcmc_qec_tpu/ops/pallas_ladder.py:144"
                     if e["source"] == "ladder_window.cu"
                     else "mcmc_qec_tpu/ops/pallas_sweep.py:42"),
        "launches": e["launches"],
        "max_abs_err": e["err"],
        "ms": e["ms"],
        "plain_ms": e["plain_ms"],
        "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"],
        "library_ms": None,
    } for e in large + wide + wide_k2 + forms]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-worker"]:
        sys.exit(ckpt_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
