"""PTEQ: parallel-tempering equivalence-class occupation decoding.

Torch counterpart of ``mcmc_qec_tpu/decoders/pteq.py``: ``PTEQ``
(depolarizing), ``PTEQ_biased``, ``PTEQ_alpha`` and
``PTEQ_alpha_with_shortest`` (decoders.py:25-105,
decoders_biasednoise.py:28-237) over ``pteq_run``.  The ladder runs on
``device``, batched over syndromes, one window of ``cfg.window`` steps
per call; the host sees each window's summaries in one transfer and runs
the convergence automaton at window granularity.  The window is fused
(``engine="auto"``/``"fused"``: ``ops/ladder_window.py``, the CUDA kernel
on a CUDA device, its plain PyTorch version on the CPU) or a loop of
unfused ladder steps (``mcmc/ladder.py::make_ladder_step``) with the same
outputs: ``"sweep"`` (the sweep kernel's general branch at a row of betas
per chain, then the top-rung logical mix), ``"literal"`` and ``"pallas"``
(the literal update, as the JAX package runs both, pteq.py:309-312 and
ladder.py:156-157).  The window kernel runs a ladder in its register
form or, where the registers cannot hold it (above 16 words per plane,
or a group too large for their shared memory), in its large variant;
where neither holds it (``ops/ladder_window.py::window_kernel_fits``,
decided from shapes before any build or launch) the fused engine runs the
``"sweep"`` window instead, the JAX package's fallback (pteq.py:306-309);
``PTEQResult.window`` says which window ran.

Semantics kept from the JAX decoder (and through it from the reference,
decoders.py:25-105): convergence is checked once per window, every syndrome
is snapshotted at the end of the window in which it converged, the result
is the uint8 floor of percentages (pteq.py:820) over the since_burn
denominator (pteq.py:653-656), and batch compaction repacks stragglers
into power-of-two buckets (pteq.py:661-718).  The host loop is the depth-1
loop (pteq.py:762-777): the fetch-batching and window-growth fields of
``PTEQConfig`` are accepted for config parity and have no effect.

Shortest-chain tracking (``track_shortest``) keeps a ``ShortestState`` on
the ladder's device: the window runs in trace mode at ``energy_chunk=1``
and its per-step class and chain-hash traces update the state step by step
(pteq.py:258-298 of the JAX package); rows are flushed to the host when
they leave the batch and at the end (pteq.py:443-470, 686-690, 821-842).

``metrics`` (a ``utils.metrics.MetricsLogger``) gets one ``pteq_window``
record per window (pteq.py:610-632 of the JAX package), built from the
summaries the window fetch already brings to the host.

``cfg.ckpt_dir`` makes the decode resumable (pteq.py:482-560, 768-775 of
the JAX package): every ``cfg.ckpt_every`` windows, after the automaton and
any compaction, the whole run state (ladder, accumulators, row map and
buckets, energy history, automaton, shortest state, and the CPU generator
that draws each window's seed, in place of the JAX key) goes to one
snapshot, and a run that finds one resumes from it bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..mcmc.ladder import (
    LadderState,
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
    init_ladder,
    make_ladder_step,
)
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from ..ops.ladder_window import (
    _weighted,
    make_ladder_window,
    window_kernel_fits,
)
from ..ops.metropolis import _log_uniform
from ..ops.pauli import make_hash_mults, pack_key
from ..utils import profiling
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics import effective_sample_size
from .convergence import EnergyHistory


@dataclasses.dataclass(frozen=True)
class PTEQConfig:
    """PT parameters; defaults follow decoders.py:25 / generate_data.py:290
    and every field of the JAX ``PTEQConfig``."""

    Nc: Optional[int] = None  # ladder length; defaults to lattice size
    SEQ: int = 2
    TOPS: int = 10
    tops_burn: int = 2
    eps: float = 0.1
    max_steps: int = 1_000_000
    iters: int = 10
    p_logical: float = 0.5
    window: int = 100
    conv_criteria: str = "error_based"
    # "auto" and "fused" run the fused window; "sweep", "literal" and
    # "pallas" a loop of unfused ladder steps (ops/engines.py)
    engine: str = "auto"
    # "sequential" (the reference's top->bottom sweep) or "even_odd" (all
    # even pairs, then all odd pairs)
    exchange: str = "sequential"
    # per-chunk mean energies; must divide ``window``
    energy_chunk: int = 4
    cum_rows_cap: int = 4096
    shortest_unique_cap: int = 128
    compact: bool = True
    compact_frac: float = 0.5
    min_compact: int = 128
    # accepted for parity with the JAX config; the port runs depth 1
    window_scale_cap: int = 1
    pipeline_depth_cap: int = 8
    pipeline_depth: Optional[int] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25


@dataclasses.dataclass
class PTEQResult:
    distribution: np.ndarray  # (B, n_classes) uint8 percentages
    converged: np.ndarray  # (B,) bool
    steps: np.ndarray  # (B,) steps taken at snapshot
    tops0: np.ndarray  # (B,)
    # with track_shortest (PTEQ_alpha_with_shortest,
    # decoders_biasednoise.py:163-172):
    shortest_boltzmann: Optional[np.ndarray] = None  # (B, K) percentages
    shortest_counts: Optional[np.ndarray] = None  # (B, K) percentages
    # (B, K) True where the unique-shortest buffer overflowed
    # (shortest_unique_cap); unique counts there are lower bounds
    shortest_overflow: Optional[np.ndarray] = None
    # device-batch sizes after each compaction (empty = never compacted)
    buckets: Tuple[int, ...] = ()
    # the window that ran: "fused" (the window kernel in either form, or its
    # plain version on the CPU) or the unfused ladder step's engine
    # ("sweep", "literal", "pallas"); "sweep" under engine="auto" or
    # "fused" where no form of the window kernel holds the ladder
    # (ops/ladder_window.py::window_kernel_fits)
    window: str = "fused"


class ShortestState(NamedTuple):
    """Shortest-n_eff tracking on the ladder's device
    (decoders_biasednoise.py:112-144): per (element, class) the running
    minimal energy, the number of samples at that minimum, and a bounded
    buffer of distinct chain keys at that minimum."""

    val: torch.Tensor  # (B, K) f32 running min energy (+inf init)
    cnt: torch.Tensor  # (B, K) i32 samples at the min
    nuq: torch.Tensor  # (B, K) i32 distinct keys recorded at the min
    ovf: torch.Tensor  # (B, K) bool buffer overflow (nuq saturated)
    keys: torch.Tensor  # (B, K, U, KEY_W) i32 distinct-key buffer


# key width: the window's 4-component chain hash
KEY_W = 4


def init_shortest(B: int, K: int, U: int, device="cpu") -> ShortestState:
    return ShortestState(
        val=torch.full((B, K), float("inf"), dtype=torch.float32, device=device),
        cnt=torch.zeros((B, K), dtype=torch.int32, device=device),
        nuq=torch.zeros((B, K), dtype=torch.int32, device=device),
        ovf=torch.zeros((B, K), dtype=torch.bool, device=device),
        keys=torch.zeros((B, K, U, KEY_W), dtype=torch.int32, device=device),
    )


def _shortest_update(sh: ShortestState, eq: torch.Tensor, kk: torch.Tensor,
                     e: torch.Tensor, burned: torch.Tensor) -> ShortestState:
    """One post-step update (JAX pteq.py:181-217): element b's class-``eq[b]``
    row sees a chain with key ``kk[b]`` at energy ``e[b]`` (ignored unless
    ``burned[b]``).  A strictly smaller energy resets the row; an equal
    energy increments the count and appends the key if unseen.

    Only row ``eq[b]`` of element b can change, so the update gathers that
    row, applies the JAX package's dense masked rule to it and scatters it
    back: the same result, bit for bit, for K times less work."""
    B, K = sh.val.shape
    U = sh.keys.shape[2]
    ar = torch.arange(B, device=eq.device)
    eq = eq.long()
    val, cnt, nuq, ovf = (a[ar, eq] for a in sh[:4])  # (B,)
    keys = sh.keys[ar, eq]  # (B, U, KEY_W)
    gate = burned > 0
    better = gate & (e < val)
    equal = gate & (e == val)
    slot_idx = torch.arange(U, device=eq.device).unsqueeze(0)  # (1, U)
    valid = slot_idx < nuq.unsqueeze(1)
    match = (keys == kk.unsqueeze(1)).all(-1)  # (B, U)
    present = (valid & match).any(-1)
    append = equal & ~present & (nuq < U)
    ovf_new = equal & ~present & (nuq >= U)
    write = better | append
    slot = torch.where(better, 0, nuq)
    onehot = slot_idx == slot.unsqueeze(1)  # (B, U)
    base = torch.where(better[:, None, None], 0, keys)
    new_keys = torch.where((write.unsqueeze(1) & onehot).unsqueeze(-1),
                           kk.unsqueeze(1), base)
    i32 = torch.int32
    rows = (
        torch.where(better, e, val),
        torch.where(better, 1, cnt + equal.to(i32)).to(i32),
        torch.where(better, 1, nuq + append.to(i32)).to(i32),
        torch.where(better, False, ovf | ovf_new),
        new_keys,
    )
    out = []
    for full, row in zip(sh, rows):
        full = full.clone()
        full[ar, eq] = row
        out.append(full)
    return ShortestState(*out)


def _shortest_scan(sh: ShortestState, eq_tr, en, key_tr, burn_any,
                   burn_first) -> ShortestState:
    """Apply a window's per-step traces (eq_trace (W, B), per-step energies
    (W, B), key_trace (W, B, 4)) in step order.  The burn gate is monotone
    within the window, so step t's flag is ``burn_any & (t >= burn_first)``
    (JAX pteq.py:283-291); steps before the first burned one change
    nothing and are skipped."""
    if not bool(burn_any.any()):
        return sh
    t0 = int(burn_first[burn_any].min())
    for t in range(t0, eq_tr.shape[0]):
        burned = (burn_any & (t >= burn_first)).to(torch.int32)
        sh = _shortest_update(sh, eq_tr[t], key_tr[t], en[t], burned)
    return sh


_WINDOW_CACHE = {}


def _get_window_fn(spec: CodeSpec, Nc: int, cfg: PTEQConfig,
                   track_shortest: bool = False,
                   top_exact_accept: bool = False,
                   equal_betas: bool = False):
    """``window(ls, seed, betas, eq_count, since_burn, weights[, sh]) ->
    (ls, eq_count, since_burn, energies, burn_any, burn_first, tops0,
    swap_acc[, sh])`` for one window of ``cfg.window`` ladder steps on the
    device of ``ls``; ``sh`` (a ``ShortestState``) only with
    ``track_shortest``."""
    if cfg.exchange not in ("sequential", "even_odd"):
        raise ValueError(
            f"exchange={cfg.exchange!r}: expected 'sequential' or 'even_odd'"
        )
    C = cfg.energy_chunk
    engine = resolve_engine(cfg.engine, "pteq")
    # the JAX package's key (pteq.py:237-239): every option that changes the
    # window's code is in it
    key = (spec.family, spec.size, Nc, cfg.iters, cfg.p_logical, cfg.window,
           cfg.tops_burn, track_shortest, engine, top_exact_accept, C,
           equal_betas, cfg.shortest_unique_cap, cfg.exchange)
    if key in _WINDOW_CACHE:
        return _WINDOW_CACHE[key]
    if engine == "fused" and not window_kernel_fits(spec, Nc, equal_betas,
                                                    cfg.iters):
        # neither form of the window kernel holds this code's ladder: the
        # same math, unfused (the JAX package's documented fallback,
        # pteq.py:306-309); on the card each ladder step's sweeps are one
        # launch of the sweep kernel
        engine = "sweep"
    if engine != "fused":
        fn = _unfused_window(spec, Nc, cfg, track_shortest, top_exact_accept,
                             engine)
        _WINDOW_CACHE[key] = fn
        return fn
    # tracking needs per-step energies and traces from the window
    Ck = 1 if track_shortest else C
    fused = make_ladder_window(spec, Nc, cfg.window, cfg.iters, cfg.p_logical,
                               cfg.tops_burn, energy_chunk=Ck,
                               top_exact=top_exact_accept,
                               equal_betas=equal_betas,
                               track_traces=track_shortest,
                               exchange=cfg.exchange)

    def window(ls: LadderState, seed: int, betas, eq_count, since_burn,
               weights, sh: Optional[ShortestState] = None):
        out = fused(ls.state, ls.flag, ls.tops0, eq_count, since_burn, seed,
                    betas, weights)
        st, fl, tp, eq, sb, en, ba, bf, sw = out[:9]
        extras = ()
        if track_shortest:
            sh = _shortest_scan(sh, out[9], en, out[10], ba, bf)
            extras = (sh,)
            if C > 1:  # chunk means for the host automaton
                en = en.reshape(en.shape[0] // C, C, -1).mean(dim=1)
        return (LadderState(st, fl, tp), eq, sb, en, ba, bf, tp, sw) + extras

    window.engine = "fused"
    _WINDOW_CACHE[key] = window
    return window


def _unfused_window(spec: CodeSpec, Nc: int, cfg: PTEQConfig,
                    track_shortest: bool, top_exact_accept: bool,
                    engine: str):
    """The window as a loop of ``cfg.window`` unfused ladder steps
    (pteq.py:309-378), with the fused window's signature and outputs:
    ``eq_count`` and ``since_burn`` advanced by the post-burn steps, the
    bottom rung's energies (chunk means), ``burn_any``/``burn_first``,
    ``tops0``, the window's accepted swaps per rung pair and, with
    ``track_shortest``, the ``ShortestState`` updated step by step from
    the bottom chain's ``pack_key`` (two halves, zero-padded to KEY_W).

    The window seed feeds a CPU generator that draws each step's sweep
    seed and the seed of one generator on the device, which draws the
    window's exchange uniforms at once and every other draw of the steps.
    ``"pallas"`` runs the literal update, as the JAX package's
    ``make_ladder_step`` does for it (ladder.py:156-157)."""
    ladder_step = make_ladder_step(
        spec, Nc, cfg.iters, cfg.p_logical,
        engine="literal" if engine == "pallas" else engine,
        top_exact_accept=top_exact_accept, exchange=cfg.exchange)
    W, C = cfg.window, cfg.energy_chunk
    mults = {}

    def window(ls: LadderState, seed: int, betas, eq_count, since_burn,
               weights, sh: Optional[ShortestState] = None):
        device = ls.state.device
        B = ls.state.shape[0]
        cpu = torch.Generator().manual_seed(int(seed))
        seeds = torch.randint(0, 2**62, (W + 1,), generator=cpu).tolist()
        gen = torch.Generator(device=device).manual_seed(seeds[-1])
        logu_swap = _log_uniform((W, Nc - 1, B), gen, device)
        w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
        eq_count = eq_count.clone()
        since_burn = since_burn.clone()
        swap_sum = torch.zeros((B, Nc - 1), dtype=torch.int32, device=device)
        energies = torch.empty((W, B), dtype=torch.float32, device=device)
        burned = torch.empty((W, B), dtype=torch.int32, device=device)
        rows = torch.arange(B, device=device)
        if track_shortest and device not in mults:
            mults[device] = torch.as_tensor(
                make_hash_mults(spec).astype(np.int64), device=device)
        for t in range(W):
            ls, beq, n0, acc = ladder_step(ls, seeds[t], betas, gen,
                                           logu_swap[t])
            b_t = (ls.tops0 >= cfg.tops_burn).to(torch.int32)
            eq_count.index_put_((rows, beq.long()), b_t, accumulate=True)
            since_burn += b_t
            swap_sum += acc
            energies[t] = _weighted(w, n0)
            burned[t] = b_t
            if track_shortest:
                kk = pack_key(spec, ls.state[:, 0], mults[device])
                kk = torch.where(kk >= 2**31, kk - 2**32, kk).to(torch.int32)
                kk = torch.cat([kk, torch.zeros_like(kk)], -1)
                sh = _shortest_update(sh, beq, kk, energies[t], b_t)
        hit = burned > 0
        burn_any = hit.any(0)
        burn_first = hit.to(torch.int32).argmax(0).to(torch.int32)
        if C > 1:
            energies = energies.view(W // C, C, B).mean(1)
        extras = (sh,) if track_shortest else ()
        return (ls, eq_count, since_burn, energies, burn_any, burn_first,
                ls.tops0, swap_sum) + extras

    window.engine = engine
    return window


def _fetch(out) -> Tuple[np.ndarray, ...]:
    """One device->host transfer of a window's summaries: (energies,
    burn_any, burn_first, tops0, swap_acc, since_burn, eq_count)."""
    _, eq, sb, en, ba, bf, tp, sw = out[:8]
    Wc, B = en.shape
    ints = torch.cat([
        ba.to(torch.int32)[:, None], bf[:, None], tp[:, None], sb[:, None],
        sw, eq,
    ], dim=1)  # (B, 4 + (Nc - 1) + K)
    flat = torch.cat([en.reshape(-1).view(torch.int32), ints.reshape(-1)])
    host = flat.cpu().numpy()
    energies = host[: Wc * B].view(np.float32).reshape(Wc, B)
    ints = host[Wc * B :].reshape(B, -1)
    n_sw = sw.shape[1]
    return (energies, ints[:, 0] > 0, ints[:, 1], ints[:, 2],
            ints[:, 4 : 4 + n_sw], ints[:, 3], ints[:, 4 + n_sw :])


def pteq_run(
    spec: CodeSpec,
    init_states,  # (B, nq) uint8 array or tensor — one syndrome per element
    beta_ladder: np.ndarray,  # (Nc, 3)
    cfg: PTEQConfig = PTEQConfig(),
    energy_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    seed: int = 0,
    track_shortest: bool = False,
    shortest_beta: float = 0.0,
    metrics=None,
    *,
    device="cuda",
) -> PTEQResult:
    """Generic PTEQ engine over an explicit beta ladder, on ``device``
    (the card unless the caller asks for ``"cpu"``).

    ``seed`` seeds a CPU ``torch.Generator`` that draws each window's
    kernel seed.  ``track_shortest`` adds the shortest-chain distributions
    to the result, weighting each unique shortest chain by
    exp(-shortest_beta * n_eff) (decoders_biasednoise.py:163-169)."""
    device = resolve_device(device)
    C = cfg.energy_chunk
    if cfg.window % C != 0:
        raise ValueError(
            f"window ({cfg.window}) must be divisible by energy_chunk ({C})"
        )
    # spans of this call (utils/profiling.py; recorded under a profiler)
    span, call = profiling.span, profiling.new_call()
    profiling.count("pteq.decodes")
    with span("pteq.start", call):
        if not isinstance(init_states, torch.Tensor):
            init_states = torch.as_tensor(np.asarray(init_states, np.uint8))
        B = init_states.shape[0]
        bl = np.asarray(beta_ladder)
        Nc = bl.shape[0]
        K = spec.n_classes
        top_exact = bool(np.allclose(bl[-1], 0.0, atol=1e-9))
        eq_b = bool(
            np.array_equal(bl[:, 0], bl[:, 1])
            and np.array_equal(bl[:, 1], bl[:, 2])
            and np.allclose(energy_weights, (1.0, 1.0, 1.0))
        )
        window_fn = _get_window_fn(spec, Nc, cfg, track_shortest, top_exact,
                                   eq_b)
        ls = init_ladder(spec, init_states.to(device), Nc)
        eq_count = torch.zeros((B, K), dtype=torch.int32, device=device)
        since_burn = torch.zeros((B,), dtype=torch.int32, device=device)
        betas = torch.as_tensor(bl, dtype=torch.float32, device=device)
        weights = np.asarray(energy_weights, np.float32)
        gen = torch.Generator().manual_seed(int(seed))

        # host automaton state; device arrays and the per-element automaton
        # arrays live in *row* space (the current device batch of size Br),
        # ``rows`` maps each row to its syndrome index (-1 = padding)
        Br = B
        # shortest-chain tracking: the running state lives on the device;
        # rows are flushed into these host arrays (original syndrome order)
        # when they leave the batch or the run ends
        sh = None
        if track_shortest:
            sh = init_shortest(B, K, cfg.shortest_unique_cap, device)
            sh_val_h = np.full((B, K), np.inf)
            sh_cnt_h = np.zeros((B, K), dtype=np.int64)
            sh_nuq_h = np.zeros((B, K), dtype=np.int64)
            sh_ovf_h = np.zeros((B, K), dtype=bool)

        rows = np.arange(B)
        buckets = []
        hist = EnergyHistory(B, max_rows=cfg.cum_rows_cap)
        burn_start = np.full(B, -1, dtype=np.int64)  # first post-burn step
        conv_start = np.zeros(B, dtype=np.int64)  # tops0 at start of streak
        in_streak = np.zeros(B, dtype=bool)
        converged = np.zeros(B, dtype=bool)
        snap_distr = np.zeros((B, K), dtype=np.float64)
        snap_steps = np.zeros(B, dtype=np.int64)
        snap_tops = np.zeros(B, dtype=np.int64)
        steps_done = 0
        n_windows = max(1, cfg.max_steps // cfg.window)

    if track_shortest:
        def finalize_sh(row_sel):
            """Flush the device's shortest stats of batch rows ``row_sel``
            into the host arrays."""
            row_sel = np.asarray(row_sel, dtype=np.int64)
            if len(row_sel) == 0:
                return
            sel_d = torch.as_tensor(row_sel, device=device)
            fv, fc, fn_, fo = (a.index_select(0, sel_d).cpu().numpy()
                               for a in sh[:4])
            orig = rows[row_sel]
            ok = orig >= 0
            sh_val_h[orig[ok]] = fv[ok]
            sh_cnt_h[orig[ok]] = fc[ok]
            sh_nuq_h[orig[ok]] = fn_[ok]
            sh_ovf_h[orig[ok]] = fo[ok]

    def log_window(w, energies, tops_now, swap_window, W):
        """The JAX package's ``pteq_window`` record (pteq.py:610-632)."""
        real = rows >= 0
        ess = float(np.mean([effective_sample_size(energies[:, b])
                             for b in np.nonzero(real)[0]])) \
            if real.any() else 0.0
        metrics.log(
            "pteq_window",
            window=w,
            steps_done=steps_done,
            swap_accept_rate=(swap_window[real].mean(axis=0) / W).tolist()
            if real.any() else [],
            tops0_rate=float(tops_now[real].mean()) / max(steps_done, 1),
            energy_ess_per_window=ess,
            energy_mean=float(energies[:, real].mean()) if real.any() else 0.0,
            converged=int(converged.sum()),
            batch_rows=int(Br),
        )

    def process_window(w, fetch):
        """Advance the convergence automaton with window ``w``'s
        summaries."""
        nonlocal steps_done, in_streak
        energies, burn_any, burn_first, tops_now, swap_window, sb, ec = fetch
        newly = (burn_start < 0) & burn_any
        if newly.any():
            burn_start[newly] = steps_done + burn_first[newly]
        W = energies.shape[0] * C
        steps_done += W
        hist.append(energies)
        if metrics is not None:
            log_window(w, energies, tops_now, swap_window, W)
        if cfg.conv_criteria != "error_based":
            return
        real = rows >= 0
        conv_r = np.ones(Br, dtype=bool)
        conv_r[real] = converged[rows[real]]
        active = ~conv_r & (tops_now >= cfg.TOPS) & (burn_start >= 0)
        if not active.any():
            return
        accept = hist.accept(np.maximum(burn_start, 0) // C, sb // C, cfg.eps)
        # streak bookkeeping (decoders.py:74-82) at window cadence
        start_streak = accept & ~in_streak
        conv_start[start_streak] = tops_now[start_streak]
        in_streak = accept
        done = active & accept & (tops_now - conv_start >= cfg.SEQ)
        if done.any():
            idx = np.nonzero(done)[0]
            orig = rows[idx]
            # since_burn counts the post-burn samples (the reference's
            # denominator since_burn+1, decoders.py:89)
            snap_distr[orig] = ec[idx] / np.maximum(sb[idx, None], 1)
            snap_steps[orig] = steps_done
            snap_tops[orig] = tops_now[idx]
            converged[orig] = True

    def compact_to():
        """New bucket size once most of the batch converged, else 0."""
        if not (cfg.compact and Br > cfg.min_compact):
            return 0
        real_idx = np.nonzero(rows >= 0)[0]
        alive = real_idx[~converged[rows[real_idx]]]
        if not (0 < len(alive) <= int(Br * cfg.compact_frac)):
            return 0
        new_Br = max(cfg.min_compact, 1 << int(len(alive) - 1).bit_length())
        return new_Br if new_Br < Br else 0

    def do_compact(new_Br):
        nonlocal ls, eq_count, since_burn, burn_start, conv_start
        nonlocal in_streak, rows, Br, sh
        real_idx = np.nonzero(rows >= 0)[0]
        alive_rows = real_idx[~converged[rows[real_idx]]]
        pad = new_Br - len(alive_rows)
        sel = np.concatenate([alive_rows, np.repeat(alive_rows[:1], pad)])
        sel_d = torch.as_tensor(sel, device=device)
        if track_shortest:
            # rows leaving the batch stop accumulating: flush them first
            finalize_sh(np.setdiff1d(real_idx, alive_rows))
            sh = ShortestState(*(t.index_select(0, sel_d) for t in sh))
        ls = LadderState(*(t.index_select(0, sel_d) for t in ls))
        eq_count = eq_count.index_select(0, sel_d)
        since_burn = since_burn.index_select(0, sel_d)
        hist.select_columns(sel)
        burn_start = burn_start[sel]
        conv_start = conv_start[sel]
        in_streak = in_streak[sel]
        rows = np.concatenate([rows[alive_rows], np.full(pad, -1, rows.dtype)])
        Br = new_Br
        buckets.append(new_Br)

    # exact mid-decode checkpoint/resume (JAX pteq.py:482-560): the
    # snapshot holds everything the later windows read, the window-seed
    # generator's state included
    ckpt = None
    w0 = 0
    sig = (B, Nc, K, cfg.window, spec.family, spec.size)
    if cfg.ckpt_dir:
        ckpt = CheckpointManager(cfg.ckpt_dir)

        def snapshot_tree():
            tree = {
                "ls_state": ls.state, "ls_flag": ls.flag,
                "ls_tops0": ls.tops0, "eq_count": eq_count,
                "since_burn": since_burn, "gen_state": gen.get_state(),
                "rows": rows,
                **{f"hist_{k}": v for k, v in hist.snapshot().items()},
                "burn_start": burn_start, "conv_start": conv_start,
                "in_streak": in_streak, "converged": converged,
                "snap_distr": snap_distr, "snap_steps": snap_steps,
                "snap_tops": snap_tops, "steps_done": np.asarray(steps_done),
                "buckets": np.asarray(buckets, dtype=np.int64),
            }
            if track_shortest:
                tree.update({f"sh_{k}": v for k, v in sh._asdict().items()})
                tree.update(sh_val_h=sh_val_h, sh_cnt_h=sh_cnt_h,
                            sh_nuq_h=sh_nuq_h, sh_ovf_h=sh_ovf_h)
            return tree

        with span("pteq.checkpoint", call):
            restored, meta = ckpt.restore_latest(snapshot_tree())
        if restored is not None:
            if tuple(meta.get("sig", ())) != sig:
                raise ValueError(
                    f"checkpoint in {cfg.ckpt_dir} was written by a different"
                    f" run: {meta.get('sig')} != {sig}"
                )
            ls = LadderState(restored["ls_state"], restored["ls_flag"],
                             restored["ls_tops0"])
            eq_count = restored["eq_count"]
            since_burn = restored["since_burn"]
            gen.set_state(restored["gen_state"])
            rows = restored["rows"]
            Br = len(rows)
            hist = EnergyHistory.restore(
                {k: restored[f"hist_{k}"] for k in ("cum", "ccnt", "span")},
                max_rows=cfg.cum_rows_cap)
            burn_start = restored["burn_start"]
            conv_start = restored["conv_start"]
            in_streak = restored["in_streak"]
            converged = restored["converged"]
            snap_distr = restored["snap_distr"]
            snap_steps = restored["snap_steps"]
            snap_tops = restored["snap_tops"]
            steps_done = int(restored["steps_done"])
            buckets = [int(b) for b in restored["buckets"]]
            if track_shortest:
                sh = ShortestState(*(restored[f"sh_{k}"]
                                     for k in ShortestState._fields))
                sh_val_h[:] = restored["sh_val_h"]
                sh_cnt_h[:] = restored["sh_cnt_h"]
                sh_nuq_h[:] = restored["sh_nuq_h"]
                sh_ovf_h[:] = restored["sh_ovf_h"]
            w0 = int(meta["window_idx"]) + 1

    # one span a phase of each window, so that the trace's idle gaps
    # between windows are put down to the phase that covered them;
    # ``_get_window_fn`` and ``_fetch`` stay looked up at call time
    for w in range(w0, n_windows):
        with span("pteq.seed", call):
            w_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
            args = (ls, w_seed, betas, eq_count, since_burn, weights)
        with span("pteq.dispatch", call):
            out = window_fn(*args, sh) if track_shortest else window_fn(*args)
        ls, eq_count, since_burn = out[:3]
        if track_shortest:
            sh = out[8]
        with span("pteq.fetch", call):
            fetch = _fetch(out)
        with span("pteq.automaton", call):
            process_window(w, fetch)
        profiling.count("pteq.windows")
        if converged.all():
            break
        with span("pteq.compact", call):
            new_Br = compact_to()
            if new_Br:
                do_compact(new_Br)
        # after the automaton and compaction, so the snapshot holds the
        # post-compact rows and buckets (JAX pteq.py:760-775)
        if ckpt is not None and (w + 1 - w0) % max(cfg.ckpt_every, 1) == 0:
            with span("pteq.checkpoint", call):
                ckpt.save(w, snapshot_tree(), {"sig": sig, "window_idx": w})

    with span("pteq.readout", call):
        # unconverged elements: snapshot at the end (the reference's "hit
        # max steps" semantics, decoders.py:84-87)
        if not converged.all():
            ec = eq_count.cpu().numpy()
            sb = since_burn.cpu().numpy()
            tops_fin = ls.tops0.cpu().numpy()
            r_idx = np.nonzero(rows >= 0)[0]
            orig = rows[r_idx]
            m = ~converged[orig]
            r_idx, orig = r_idx[m], orig[m]
            snap_distr[orig] = ec[r_idx] / np.maximum(sb[r_idx, None], 1)
            snap_steps[orig] = steps_done
            snap_tops[orig] = tops_fin[r_idx]

        sh_boltz = sh_counts = sh_overflow = None
        if track_shortest:
            finalize_sh(np.nonzero(rows >= 0)[0])
            # Boltzmann over unique shortest chains: each unique chain at
            # the class's shortest n_eff contributes exp(-beta * n_eff)
            # (decoders_biasednoise.py:163-169; JAX pteq.py:821-842)
            n_unique = sh_nuq_h.astype(np.float64)
            with np.errstate(invalid="ignore"):
                logw = -shortest_beta * np.where(np.isfinite(sh_val_h),
                                                 sh_val_h, np.inf)
                # a row with no finite weight gives NaN and then 0, as the
                # JAX package's nanmax does
                top = np.max(np.where(np.isfinite(logw), logw, -np.inf),
                             axis=1, keepdims=True)
                w_ = n_unique * np.exp(logw - top)
            w_ = np.where(np.isfinite(w_), w_, 0.0)
            tot = w_.sum(axis=1, keepdims=True)
            sh_boltz = np.where(tot > 0, w_ / np.maximum(tot, 1e-300) * 100,
                                0.0)
            ctot = sh_cnt_h.sum(axis=1, keepdims=True)
            sh_counts = np.where(ctot > 0,
                                 sh_cnt_h / np.maximum(ctot, 1) * 100, 0.0)
            sh_overflow = sh_ovf_h
        distribution = (snap_distr * 100).astype(np.uint8)
    return PTEQResult(
        distribution=distribution,
        converged=converged,
        steps=snap_steps,
        tops0=snap_tops,
        shortest_boltzmann=sh_boltz,
        shortest_counts=sh_counts,
        shortest_overflow=sh_overflow,
        buckets=tuple(buckets),
        window=window_fn.engine,
    )


def PTEQ(
    spec: CodeSpec,
    init_states,
    p: float,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
    *,
    device="cuda",
) -> PTEQResult:
    """Depolarizing PTEQ (decoders.py:25-89), batched over syndromes on
    ``device`` (the card by default; ``"cpu"`` runs the plain window)."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_depolarizing(p, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (1.0, 1.0, 1.0), seed,
                    metrics=metrics, device=device)


def PTEQ_biased(
    spec: CodeSpec,
    init_states,
    p: float,
    eta: float = 0.5,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
    *,
    device="cuda",
) -> PTEQResult:
    """Biased-noise PTEQ (decoders_biasednoise.py:28-75) on ``device``."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_biased(p, eta, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (1.0, 1.0, 1.0), seed,
                    metrics=metrics, device=device)


def PTEQ_alpha(
    spec: CodeSpec,
    init_states,
    pz_tilde: float,
    alpha: float = 1.0,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
    *,
    device="cuda",
) -> PTEQResult:
    """Alpha-noise PTEQ on effective length n_eff = n_z + alpha (n_x + n_y)
    (decoders_biasednoise.py:175-222) on ``device``."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (alpha, alpha, 1.0), seed,
                    metrics=metrics, device=device)


def PTEQ_alpha_with_shortest(
    spec: CodeSpec,
    init_states,
    pz_tilde: float,
    alpha: float = 1.0,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    *,
    device="cuda",
) -> PTEQResult:
    """Alpha PTEQ that also tracks the unique shortest-n_eff chains per
    class (decoders_biasednoise.py:93-172) on ``device``.  The result's
    ``shortest_boltzmann`` and ``shortest_counts`` carry the two extra
    distributions the reference returns."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
    return pteq_run(
        spec, init_states, ladder, cfg, (alpha, alpha, 1.0), seed,
        track_shortest=True, shortest_beta=float(-np.log(pz_tilde)),
        device=device,
    )
