"""PTEQ: parallel-tempering equivalence-class occupation decoding.

Torch counterpart of ``mcmc_qec_tpu/decoders/pteq.py`` for depolarizing
noise.  The ladder runs on ``device``, batched over syndromes, one fused
window of ``cfg.window`` steps per call (``ops/ladder_window.py``: the CUDA
kernel on a CUDA device, its plain PyTorch version on the CPU); the host
sees each window's summaries in one transfer and runs the convergence
automaton at window granularity.

Semantics kept from the JAX decoder (and through it from the reference,
decoders.py:25-105): convergence is checked once per window, every syndrome
is snapshotted at the end of the window in which it converged, the result
is the uint8 floor of percentages (pteq.py:820) over the since_burn
denominator (pteq.py:653-656), and batch compaction repacks stragglers
into power-of-two buckets (pteq.py:661-718).  The host loop is the depth-1
loop (pteq.py:762-777): the fetch-batching and window-growth fields of
``PTEQConfig`` are accepted for config parity and have no effect.

Not ported yet (raise ``NotImplementedError``): checkpointing, shortest-chain
tracking, per-window metrics, ladders other than equal betas with a zero
top rung (biased and alpha PTEQ) and ``exchange="even_odd"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..mcmc.ladder import LadderState, beta_ladder_depolarizing, init_ladder
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from ..ops.ladder_window import make_ladder_window
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
    # "auto" and "fused" run the fused window; the other engines are not
    # ported yet (ops/engines.py)
    engine: str = "auto"
    # "sequential" (the reference's top->bottom sweep); "even_odd" is not
    # ported yet
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
    shortest_boltzmann: Optional[np.ndarray] = None  # not ported
    shortest_counts: Optional[np.ndarray] = None  # not ported
    shortest_overflow: Optional[np.ndarray] = None  # not ported
    # device-batch sizes after each compaction (empty = never compacted)
    buckets: Tuple[int, ...] = ()


_WINDOW_CACHE = {}


def _get_window_fn(spec: CodeSpec, Nc: int, cfg: PTEQConfig,
                   track_shortest: bool = False,
                   top_exact_accept: bool = False,
                   equal_betas: bool = False):
    """``window(ls, seed, betas, eq_count, since_burn, weights) -> (ls,
    eq_count, since_burn, energies, burn_any, burn_first, tops0, swap_acc)``
    for one window of ``cfg.window`` ladder steps on the device of ``ls``."""
    if cfg.exchange not in ("sequential", "even_odd"):
        raise ValueError(
            f"exchange={cfg.exchange!r}: expected 'sequential' or 'even_odd'"
        )
    if cfg.exchange == "even_odd":
        raise NotImplementedError(
            "exchange='even_odd' is not ported yet (ROADMAP.md queue 2, K2 "
            "even_odd branch)"
        )
    if track_shortest:
        raise NotImplementedError(
            "track_shortest is not ported yet (ROADMAP.md queue 1, "
            "'Biased/alpha PTEQ')"
        )
    if not (top_exact_accept and equal_betas):
        raise NotImplementedError(
            "only ladders with equal per-Pauli betas and a zero top rung "
            "(beta_ladder_depolarizing) are ported; biased and alpha ladders "
            "need K2's general branches (ROADMAP.md queue 2)"
        )
    engine = resolve_engine(cfg.engine, "pteq")
    key = (spec.family, spec.size, Nc, cfg.iters, cfg.p_logical, cfg.window,
           cfg.tops_burn, engine, cfg.energy_chunk)
    if key in _WINDOW_CACHE:
        return _WINDOW_CACHE[key]
    fused = make_ladder_window(spec, Nc, cfg.window, cfg.iters, cfg.p_logical,
                               cfg.tops_burn, energy_chunk=cfg.energy_chunk,
                               top_exact=top_exact_accept,
                               equal_betas=equal_betas)

    def window(ls: LadderState, seed: int, betas, eq_count, since_burn,
               weights):
        st, fl, tp, eq, sb, en, ba, bf, sw = fused(
            ls.state, ls.flag, ls.tops0, eq_count, since_burn, seed, betas,
            weights,
        )
        return LadderState(st, fl, tp), eq, sb, en, ba, bf, tp, sw

    _WINDOW_CACHE[key] = window
    return window


def _fetch(out) -> Tuple[np.ndarray, ...]:
    """One device->host transfer of a window's summaries: (energies,
    burn_any, burn_first, tops0, swap_acc, since_burn, eq_count)."""
    _, eq, sb, en, ba, bf, tp, sw = out
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
    kernel seed."""
    del shortest_beta  # only used with track_shortest
    device = resolve_device(device)
    if cfg.ckpt_dir:
        raise NotImplementedError(
            "ckpt_dir: checkpoint/resume is not ported yet (ROADMAP.md queue "
            "1, 'Pipeline + CLI')"
        )
    if metrics is not None:
        raise NotImplementedError(
            "metrics: per-window metrics are not ported yet (ROADMAP.md queue "
            "1, 'Multi-device + utils')"
        )
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
    window_fn = _get_window_fn(spec, Nc, cfg, track_shortest, top_exact, eq_b)

    C = cfg.energy_chunk
    if cfg.window % C != 0:
        raise ValueError(
            f"window ({cfg.window}) must be divisible by energy_chunk ({C})"
        )
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
    rows = np.arange(B)
    buckets = []
    hist = EnergyHistory(B, max_rows=cfg.cum_rows_cap)
    burn_start = np.full(B, -1, dtype=np.int64)  # first post-burn step idx
    conv_start = np.zeros(B, dtype=np.int64)  # tops0 at start of streak
    in_streak = np.zeros(B, dtype=bool)
    converged = np.zeros(B, dtype=bool)
    snap_distr = np.zeros((B, K), dtype=np.float64)
    snap_steps = np.zeros(B, dtype=np.int64)
    snap_tops = np.zeros(B, dtype=np.int64)
    steps_done = 0
    n_windows = max(1, cfg.max_steps // cfg.window)

    def process_window(fetch):
        """Advance the convergence automaton with one window's summaries."""
        nonlocal steps_done, in_streak
        energies, burn_any, burn_first, tops_now, _, sb, ec = fetch
        newly = (burn_start < 0) & burn_any
        if newly.any():
            burn_start[newly] = steps_done + burn_first[newly]
        steps_done += energies.shape[0] * C
        hist.append(energies)
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
        nonlocal in_streak, rows, Br
        real_idx = np.nonzero(rows >= 0)[0]
        alive_rows = real_idx[~converged[rows[real_idx]]]
        pad = new_Br - len(alive_rows)
        sel = np.concatenate([alive_rows, np.repeat(alive_rows[:1], pad)])
        sel_d = torch.as_tensor(sel, device=device)
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

    for _ in range(n_windows):
        w_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        out = window_fn(ls, w_seed, betas, eq_count, since_burn, weights)
        ls, eq_count, since_burn = out[:3]
        process_window(_fetch(out))
        if converged.all():
            break
        new_Br = compact_to()
        if new_Br:
            do_compact(new_Br)

    # unconverged elements: snapshot at the end (the reference's "hit max
    # steps" semantics, decoders.py:84-87)
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

    return PTEQResult(
        distribution=(snap_distr * 100).astype(np.uint8),
        converged=converged,
        steps=snap_steps,
        tops0=snap_tops,
        buckets=tuple(buckets),
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
