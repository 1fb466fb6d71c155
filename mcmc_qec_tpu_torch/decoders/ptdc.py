"""PTDC / PTRC: parallel-tempering sampled counting decoders
(decoders.py:138-233, 584-742).

Counterpart of ``mcmc_qec_tpu/decoders/ptdc.py``.  Like STDC/STRC, but the
samples come from a PT ladder per (syndrome, class, droplet): every rung
contributes a record each ladder step (decoders.py:146-153, 597-623), and
the step budget is divided by Nc (decoders.py:199, 669).

The ladder is ``mcmc/ladder.py::make_perm_ladder_step``: the chains keep
their rows and carry their rung, and a step records every rung's key and
X/Y/Z counts in rung order.  On the card each ladder step is one recording
launch of the sweep kernel (one step, a row of betas per chain) plus the
exchange in torch, so a decode makes one sweep-kernel launch per ladder
step.  The steps run in windows of ``stream_window`` (256 by default): a
window's exchange uniforms are drawn at once, and each window either
feeds the bounded-memory streaming reduction (``decoders/streaming.py``,
rungs as droplets) or is kept for the materialised reduction.  Both paths
draw the same samples from ``seed``, so they agree wherever the stream's
buffers never overflow.

PTDC: Z = sum over the unique chains of every rung and droplet of
exp(-beta_err . n).  PTRC: the ratio estimate per rung, top rung excluded,
in log space on the device (``_ptrc_reduce``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..mcmc.ladder import (
    LadderState,
    beta_ladder_depolarizing,
    betas_depolarizing,
    init_ladder,
    make_perm_ladder_step,
    perm_enter,
)
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from ..ops.metropolis import _log_uniform
from .counting import (
    SampleStream,
    _weighted_length,
    conv_mult_valid_mask,
    occupancy_stats,
    z_direct_count,
)
from .stdc import _as_states, _class_seeds
from .streaming import (
    logz_from_stream,
    occupancy_from_stream,
    should_stream,
    stream_timing,
    streaming_scan,
    warn_stream_overflow,
)
from .strc import _warn_occupancy_truncation


def _pt_iters(engine: str) -> int:
    """Updates per recorded ladder step (ptdc.py:64-73): the reference
    records every ladder step of iters=10 single-stabilizer proposals per
    rung (decoders.py:146-153, mcmc.py:94); one colored sweep is 2d^2
    proposals per rung, so the sweep engine records after one sweep."""
    return 10 if resolve_engine(engine, "chain") == "literal" else 1


def _pt_seeds(spec: CodeSpec, init_states, device) -> torch.Tensor:
    """(B, K, nq) uint8 class seeds on ``device``: one per class of each
    (B, nq) state, or (B, K, nq) warm starts as given (ptdc.py:76-80)."""
    return _class_seeds(spec, _as_states(init_states, device))


def _pt_draws(seed: int, steps: int) -> torch.Tensor:
    """(steps, 2) int64 per-step seeds on the CPU: column 0 keys the sweep
    kernel's launch of the step, column 1 of a window's first step seeds
    the generator of that window's other draws."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**62, (steps, 2), generator=gen)


def _droplet_states(seeds: torch.Tensor, droplets: int) -> torch.Tensor:
    """(B * K * droplets, nq): every droplet of a (syndrome, class) starts
    at its class seed (ptdc.py:102-105)."""
    B, K, nq = seeds.shape
    return seeds[:, :, None, :].expand(B, K, droplets, nq).reshape(-1, nq)


def make_pt_window(spec: CodeSpec, Nc: int, iters: int, engine: str,
                   betas_ladder: torch.Tensor):
    """``window(pls, draws_w) -> (pls, keys (n, N, Nc, 2) int64, n_xyz (n,
    N, Nc, 3) int32)``: ``n = len(draws_w)`` perm-ladder steps of the N
    ladders, each recording every rung in rung order.  ``draws_w`` is the
    window's (n, 2) slice of ``_pt_draws``: the sweep kernel's seeds go to
    the device once, and one generator seeded from the first row draws the
    window's exchange uniforms at once and the literal engine's proposals.
    With ``stream_timing`` on, every step adds its "sweep" and "exchange"
    device time."""
    step = make_perm_ladder_step(spec, Nc, iters, engine=engine,
                                 timing=stream_timing)

    def window(pls, draws_w):
        device = pls.state.device
        n, N = len(draws_w), pls.state.shape[0]
        gen = torch.Generator(device=device).manual_seed(int(draws_w[0, 1]))
        seeds = draws_w[:, 0].to(device)
        logu = _log_uniform((n, Nc - 1, N), gen, device)
        keys = torch.empty((n, N, Nc, 2), dtype=torch.int64, device=device)
        nxyz = torch.empty((n, N, Nc, 3), dtype=torch.int32, device=device)
        for t in range(n):
            pls, keys[t], nxyz[t], _ = step(pls, seeds[t:t + 1], betas_ladder,
                                            gen, logu[t])
        return pls, keys, nxyz

    return window


def _run_windows(window_fn, pls, draws, window: int):
    """Every window of ``draws`` in turn; (pls, keys (steps, N, Nc, 2),
    n_xyz (steps, N, Nc, 3))."""
    keys, nxyz = [], []
    for s0 in range(0, len(draws), window):
        pls, k, c = window_fn(pls, draws[s0:s0 + window])
        keys.append(k)
        nxyz.append(c)
    return pls, torch.cat(keys), torch.cat(nxyz)


def _get_pt_sampler(spec: CodeSpec, Nc: int, steps: int, iters: int,
                    engine: str = "literal", window: int = 256):
    """Sampler over N ladders recording every rung each step (ptdc.py:26-61):
    ``run(ls_state (N, Nc, nq), ls_flag, ls_tops, seed, betas_ladder (Nc,
    3)) -> (keys (N, Nc, steps, 2) int64, n_xyz (N, Nc, steps, 3) int32)``,
    ``steps`` perm-ladder steps in windows of ``window`` (``_pt_draws``)."""

    def run(ls_state, ls_flag, ls_tops, seed, betas_ladder):
        window_fn = make_pt_window(spec, Nc, iters, engine, betas_ladder)
        pls = perm_enter(LadderState(ls_state, ls_flag, ls_tops))
        _, keys, nxyz = _run_windows(window_fn, pls, _pt_draws(seed, steps),
                                     window)
        # (steps, N, Nc, .) -> (N, Nc, steps, .)
        return keys.permute(1, 2, 0, 3), nxyz.permute(1, 2, 0, 3)

    return run


def _pt_stream(spec: CodeSpec, seeds: torch.Tensor, p_sampling: float,
               Nc: int, steps: int, droplets: int, iters: int, seed: int,
               engine: str = "auto", window: int = 256):
    """Run the droplet PT ladders of every (syndrome, class) of ``seeds``
    (B, K, nq) for ``steps`` ladder steps and materialise the records with
    axes (B, K, Nc, droplets * steps), droplet-major (ptdc.py:83-113).
    Returns (SampleStream, the (Nc, 3) numpy ladder)."""
    B, K, nq = seeds.shape
    ladder = beta_ladder_depolarizing(p_sampling, Nc)
    betas = torch.as_tensor(ladder, dtype=torch.float32, device=seeds.device)
    ls = init_ladder(spec, _droplet_states(seeds, droplets), Nc)
    keys, nxyz = _get_pt_sampler(spec, Nc, steps, iters, engine, window)(
        ls.state, ls.flag, ls.tops0, seed, betas)
    # (B*K*D, Nc, steps, .) -> (B, K, Nc, D*steps, .)
    keys = keys.reshape(B, K, droplets, Nc, steps, 2).transpose(2, 3)
    nxyz = nxyz.reshape(B, K, droplets, Nc, steps, 3).transpose(2, 3)
    return SampleStream(keys.reshape(B, K, Nc, droplets * steps, 2),
                        nxyz.reshape(B, K, Nc, droplets * steps, 3)), ladder


def _pt_stream_scan(spec: CodeSpec, seeds: torch.Tensor, betas_ladder,
                    Nc: int, steps: int, window: int, iters: int, engine: str,
                    droplets: int, capacity: int, per_rung: bool, seed: int,
                    betas_error=None):
    """Streaming PT sampler (ptdc.py:116-190): the ladders advance window
    by window and every rung's records are folded into bounded buffers, no
    (B, K, Nc, droplets * steps) stream in memory.  per_rung=False (PTDC):
    one buffer per (B, K), all rungs and droplets merged (droplet axis
    droplets * Nc), rank = the Boltzmann weight at ``betas_error``.
    per_rung=True (PTRC): one buffer per (B, K, Nc) ranked by total length,
    with exact per-length occupancy.  Returns the StreamState."""
    B, K, nq = seeds.shape
    window_fn = make_pt_window(spec, Nc, iters, engine, betas_ladder)
    D = droplets

    def chunk(pls, draws_w):
        pls, keys, nxyz = window_fn(pls, draws_w)
        n = keys.shape[0]
        # (n, B*K*D, Nc, .) -> rows and droplets of the buffers
        keys = keys.view(n, B, K, D, Nc, 2)
        nxyz = nxyz.view(n, B, K, D, Nc, 3)
        order = (1, 2, 4, 3, 0, 5) if per_rung else (1, 2, 3, 4, 0, 5)
        shape = (B * K * Nc, D) if per_rung else (B * K, D * Nc)
        return (pls, keys.permute(order).reshape(shape + (n, 2)),
                nxyz.permute(order).reshape(shape + (n, 3)))

    if per_rung:
        R, Dr = B * K * Nc, D
        rank_fn = lambda nx: nx.sum(-1).to(torch.float32)  # noqa: E731
    else:
        R, Dr = B * K, D * Nc
        rank_fn = lambda nx: _weighted_length(nx, betas_error)  # noqa: E731
    pls = perm_enter(init_ladder(spec, _droplet_states(seeds, D), Nc))
    _, st, _ = streaming_scan(
        chunk, pls, _pt_draws(seed, steps),
        steps=steps, window=window,
        # a row never holds more unique chains than its samples
        capacity=min(capacity, Dr * steps),
        rank_fn=rank_fn, nq=nq, R=R, D=Dr, track_occupancy=per_rung,
    )
    return st


def PTDC(
    spec: CodeSpec,
    init_states,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 4,
    Nc: Optional[int] = None,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream="auto",
    stream_capacity: int = 4096,
    stream_window: int = 256,
    conv_mult: float = 0.0,
    *,
    device="cuda",
) -> np.ndarray:
    """Direct counting over PT samples (decoders.py:168-233; ptdc.py:193-
    298): all rungs' visits enter one unique-chain set per class, Z =
    sum_unique exp(-beta_err n).  Returns (B, K) uint8 percentages
    (decoders.py:233).  ``init_states`` is (B, nq) or (B, K, nq) warm
    starts, numpy or a tensor.

    ``stream``: "auto" switches to the bounded-memory streaming reduction
    once the materialised stream would pass ~1 GiB.  ``conv_mult``: the
    shortest-chain extension rule over each droplet ladder's combined rung
    stream (decoders.py:156-161), whose step is the outer ladder step; it
    needs the chronological per-droplet stream, so it forces the
    materialised path."""
    device = resolve_device(device)
    p_sampling = p_sampling or p_error
    Nc = Nc or spec.size
    steps_eff = steps // Nc
    iters = _pt_iters(engine)
    be = torch.as_tensor(betas_depolarizing(p_error), dtype=torch.float32,
                         device=device)
    seeds = _pt_seeds(spec, init_states, device)
    B, K = seeds.shape[:2]
    window = min(stream_window, steps_eff)
    use_stream = should_stream(stream, B * K, droplets * Nc, steps_eff)
    if conv_mult:
        use_stream = False
    if use_stream:
        betas = torch.as_tensor(beta_ladder_depolarizing(p_sampling, Nc),
                                dtype=torch.float32, device=device)
        st = _pt_stream_scan(spec, seeds, betas, Nc, steps_eff, window,
                             iters, engine, droplets, stream_capacity, False,
                             seed, be)
        overflow = st.overflow.cpu().numpy()
        if overflow.any():
            # min_rank reduced on the device: the host fetches (R,) values,
            # not the (R, capacity) buffer (ptdc.py:232-244)
            min_rank = torch.where(torch.isfinite(st.r), st.r,
                                   torch.inf).amin(-1)
            warn_stream_overflow(overflow, st.max_kept.cpu().numpy(),
                                 min_rank.cpu().numpy(),
                                 droplets * Nc * steps_eff, "PTDC",
                                 stream_capacity)
        logz = logz_from_stream(st).reshape(B, K)
    else:
        stream_s, _ = _pt_stream(spec, seeds, p_sampling, Nc, steps_eff,
                                 droplets, iters, seed, engine, window)
        valid = None
        if conv_mult:
            # the chronological per-droplet stream: step-major, rung-minor
            # (the reference records every rung of a step before advancing,
            # decoders.py:146-153)
            k5 = stream_s.keys.view(B, K, Nc, droplets, steps_eff, 2)
            n5 = stream_s.n_xyz.view(B, K, Nc, droplets, steps_eff, 3)
            kc = k5.permute(0, 1, 3, 4, 2, 5).reshape(
                B * K * droplets, steps_eff * Nc, 2)
            nc_ = n5.permute(0, 1, 3, 4, 2, 5).reshape(
                B * K * droplets, steps_eff * Nc, 3)
            t_idx = torch.arange(steps_eff, device=device).repeat_interleave(Nc)
            # the break may fire only after a step's last rung
            # (decoders.py:156-161)
            step_end = (torch.arange(Nc, device=device) == Nc - 1).repeat(
                steps_eff)
            valid = conv_mult_valid_mask(
                kc, nc_.sum(-1).to(torch.float32), conv_mult, steps_eff,
                t=t_idx, step_end=step_end,
            ).reshape(B, K, droplets * steps_eff * Nc)
            merged = SampleStream(kc.reshape(B, K, -1, 2),
                                  nc_.reshape(B, K, -1, 3))
        else:
            # the rung axis merges into the sample axis: dedup across the
            # whole ladder
            merged = SampleStream(stream_s.keys.reshape(B, K, -1, 2),
                                  stream_s.n_xyz.reshape(B, K, -1, 3))
        logz = z_direct_count(merged, be, valid=valid)
    distr = torch.softmax(logz, -1) * 100.0
    return distr.cpu().numpy().astype(np.uint8)


def _ptrc_reduce(m_n, N_n, shortest, next_shortest, beta_ladder, beta_err,
                 nq: int) -> torch.Tensor:
    """The PTRC reduction over rungs and lengths in log space, float32
    (ptdc.py:301-342).  Inputs have axes (B, K, Nc, [nq+1]); the top rung
    (infinite temperature) is excluded like the reference
    (decoders.py:726).  Returns (B, K) percentages; all-zero for a
    syndrome no class of which has a finite Z."""
    f32 = torch.float32
    dev = m_n.device
    m = m_n[..., :-1, :].to(f32)  # (B, K, R, nq+1)
    N = N_n[..., :-1, :].to(f32)
    l0 = shortest[..., :-1].to(f32)  # (B, K, R)
    l1 = next_shortest[..., :-1].to(f32)
    bl = torch.as_tensor(beta_ladder, dtype=f32, device=dev)[:-1]  # (R,)
    db = bl - torch.as_tensor(beta_err, dtype=f32, device=dev)

    def take(arr, idx):
        return arr.gather(-1, idx.to(torch.int64).clamp(0, nq)[..., None])[..., 0]

    c0 = take(N, l0) / take(m, l0).clamp(min=1.0)
    c1 = (take(N, l1) / take(m, l1).clamp(min=1.0)
          * torch.exp(-bl * (l1 - l0).clamp(min=0.0)))
    C = torch.where(l1 <= nq, 0.5 * (c0 + c1), c0)
    ns = torch.arange(nq + 1, dtype=f32, device=dev)
    logm = torch.where(m > 0, torch.log(m.clamp(min=1e-30)), -torch.inf)
    expo = ns * db[None, None, :, None] - (bl * l0)[..., None] + logm
    logZ_i = torch.log(C.clamp(min=1e-30)) + torch.logsumexp(expo, -1)
    logZ_i = torch.where((l0 <= nq) & (C > 0), logZ_i, -torch.inf)
    logZ = torch.logsumexp(logZ_i, -1)  # (B, K)
    any_fin = torch.isfinite(logZ).any(-1, keepdim=True)
    logZ_safe = torch.where(torch.isfinite(logZ), logZ, -1e30)
    return torch.where(any_fin, torch.softmax(logZ_safe, -1) * 100.0, 0.0)


def PTRC(
    spec: CodeSpec,
    init_states,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 4,
    Nc: Optional[int] = None,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream="auto",
    stream_capacity: int = 2048,
    stream_window: int = 256,
    conv_mult: float = 2.0,
    *,
    device="cuda",
) -> np.ndarray:
    """Ratio counting over PT samples (decoders.py:638-742; ptdc.py:345-
    449): per rung i but the top,

        C_i    = mean over the two shortest lengths of
                 N(l)/m(l) * exp(-beta_i (l - l_min))        (decoders.py:734)
        Z_i    = C_i * sum_n m(n) exp(n d_beta_i - beta_i l_min)
        Z_eq   = sum_i Z_i

    with beta_i from the p-ladder and d_beta_i = beta_i - beta_error.
    Returns (B, K) uint8 percentages (decoders.py:742).  ``conv_mult`` is
    accepted for signature parity and ignored, as in the reference, whose
    break is commented out (decoders.py:626-631)."""
    del conv_mult
    device = resolve_device(device)
    p_sampling = p_sampling or p_error
    Nc = Nc or spec.size
    steps_eff = steps // Nc
    iters = _pt_iters(engine)
    nq = spec.nq
    seeds = _pt_seeds(spec, init_states, device)
    B, K = seeds.shape[:2]
    ladder = beta_ladder_depolarizing(p_sampling, Nc)
    window = min(stream_window, steps_eff)
    if should_stream(stream, B * K, droplets * Nc, steps_eff):
        betas = torch.as_tensor(ladder, dtype=torch.float32, device=device)
        st = _pt_stream_scan(spec, seeds, betas, Nc, steps_eff, window,
                             iters, engine, droplets, stream_capacity, True,
                             seed)
        occ = occupancy_from_stream(st, nq)
        m_n = occ.m_n.reshape(B, K, Nc, nq + 1)
        N_n = occ.N_n.reshape(B, K, Nc, nq + 1)
        shortest = occ.shortest.reshape(B, K, Nc)
        next_shortest = occ.next_shortest.reshape(B, K, Nc)
        trunc_bad = (torch.isfinite(occ.trunc_at)
                     & (occ.trunc_at <= occ.next_shortest.to(torch.float32))
                     ).reshape(B, K, Nc)
        # the top (infinite-temperature) rung is excluded from the
        # reduction (decoders.py:726): no warning about it
        _warn_occupancy_truncation(trunc_bad[..., :-1].cpu().numpy(), "PTRC",
                                   stream_capacity)
    else:
        stream_s, _ = _pt_stream(spec, seeds, p_sampling, Nc, steps_eff,
                                 droplets, iters, seed, engine, window)
        st = occupancy_stats(stream_s, nq)  # (B, K, Nc, nq+1)
        m_n, N_n = st.m_n, st.N_n
        shortest, next_shortest = st.shortest, st.next_shortest
    beta_err = float(betas_depolarizing(p_error)[0])
    distr = _ptrc_reduce(m_n, N_n, shortest, next_shortest,
                         np.asarray(ladder[:, 0], np.float32), beta_err, nq)
    return distr.cpu().numpy().astype(np.uint8)
