"""STDC: single-temperature direct counting decoders.

Counterpart of ``mcmc_qec_tpu/decoders/stdc.py``.  For every syndrome, all
(class x droplet) chains run in one batch at the sampling temperature: the
sampling loop, one colored sweep per recording step with the visits
recorded as content keys and per-Pauli counts, runs on the sweep kernel
(``ops/sweep.py``), and Z_E = sum over unique chains of exp(-beta_err .
n_xyz) comes from a sort and a segment logsumexp.  Two paths:

- materialised: the whole loop is one kernel launch and the reduction
  sorts the whole (B, K, droplets * steps) stream
  (``counting.py::make_sampler``, ``z_direct_count``);
- streamed (``stream=True``, or ``"auto"`` once the materialised stream
  would pass 1 GiB): one launch per window of ``stream_window`` steps,
  each window sort-merged into a bounded buffer of the ``stream_capacity``
  lowest-weight unique chains per (syndrome, class)
  (``decoders/streaming.py``), so the reference's default budget
  (droplets=10 x steps=20000) runs at any batch.  Both draw the same
  samples; the streamed Z equals the materialised one whenever the buffer
  never overflows.

``engine``: ``"auto"``/``"pallas"`` (the sweep kernel, the total-count
branch when the sampling betas are equal), ``"sweep"`` (the sweep kernel's
per-Pauli branch) or ``"literal"``/``"fused"`` (the literal update, five
proposals per recorded step for ``"literal"``, one for ``"fused"``, as the
JAX package runs them).

All four reference variants are one engine with two beta vectors:
 - STDC:                    betas_sampling = depolarizing(p_sampling),
                            betas_err = depolarizing(p_error)
 - STDC_general_noise:      vector betas (a scalar p_sampling gives equal
                            sampling betas, decoders.py:351-354)
 - STDC_Nall_n_alpha:       alpha forms (decoders.py:537-581)
Equal sampling betas take the sweep kernel's total-count branch.
``conv_mult`` is the reference's early-stop rule (decoders.py:249-263) and
``metrics`` logs one ``stdc_run`` record of unique-discovery saturation.

Every entry point runs on ``device`` ("cuda" by default; "cpu" runs the
plain sweep).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..mcmc.ladder import betas_depolarizing, betas_xyz
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from ..ops.pauli import all_class_states
from .counting import (
    _weighted_length,
    chronological_first_occurrence,
    class_droplets,
    conv_mult_valid_mask,
    make_chunk_sampler,
    make_sampler,
    sample_classes,
    step_seeds,
    z_direct_count,
)
from .streaming import (
    CONV_MULT_UNIQUE_CAP,
    logz_from_stream,
    should_stream,
    streaming_scan,
    warn_conv_mult_overflow,
    warn_stream_overflow,
)


def _iters(engine: str) -> int:
    """Updates per recorded step of a resolved counting engine: five
    proposals on the literal engine, one colored sweep otherwise
    (stdc.py:55, strc.py:84)."""
    return 5 if engine == "literal" else 1


def _mode(shortest_mode) -> str:
    """"off" (full Z), "only" (shortest-truncated Z) or "both" (full +
    shortest from one sampled stream, decoders.py:490-505); bools are
    accepted (False="off", True="only")."""
    if isinstance(shortest_mode, bool):
        return "only" if shortest_mode else "off"
    return shortest_mode


def _percentages(logz, shortest_mode):
    """Normalised percentages via a stable softmax (== Z / sum Z * 100,
    decoders.py:322): (distr, logz), or ((full, shortest), logz) with
    "both"."""
    if shortest_mode == "both":
        logz, logz_s = logz
        return ((torch.softmax(logz, -1) * 100.0,
                 torch.softmax(logz_s, -1) * 100.0), logz)
    return torch.softmax(logz, -1) * 100.0, logz


@functools.lru_cache(maxsize=None)
def _get_stdc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 shortest_mode: str, conv_mult: float = 0.0,
                 engine: str = "auto", with_stats: bool = False,
                 equal_betas: bool = False):
    """``run(class_states (B, K, nq), seed, betas_sampling, betas_error) ->
    (distr, logz)`` on the device of ``class_states``, plus ``((u_tot,
    u_half),)`` per (B, K) with ``with_stats``: unique chains in total and
    in the first half of each droplet's steps, the saturation diagnostic
    (stdc.py:88-105).  ``run.sample`` and ``run.reduce`` are its two
    halves (sampling loop; mask, dedup and Z), which ``run`` calls in
    turn."""
    shortest_mode = _mode(shortest_mode)
    engine = resolve_engine(engine, "counting")
    # one colored sweep per recorded step, five proposals on the literal
    # engine (stdc.py:55)
    sampler = make_sampler(spec, steps, iters_per_step=_iters(engine),
                           engine=engine, equal_betas=equal_betas)

    def sample(class_states, seed, betas_sampling):
        return sample_classes(spec, sampler, class_states, seed,
                              betas_sampling, droplets, steps, randomize)

    def reduce(stream, betas_error):
        B, K, N = stream.keys.shape[:3]
        valid = None
        if conv_mult:
            # per-droplet early-stop mask (decoders.py:249-263); the merged
            # axis is droplet-major
            n_tot = stream.n_xyz.sum(-1).to(torch.float32)
            valid = conv_mult_valid_mask(
                stream.keys.reshape(B, K, droplets, steps, 2),
                n_tot.reshape(B, K, droplets, steps), conv_mult, steps,
            ).reshape(B, K, N)
        stats = ()
        if with_stats:
            first = chronological_first_occurrence(stream.keys)
            # half-time = the first half of each droplet's own steps, the
            # streaming path's halfway snapshot
            t = torch.arange(N, device=first.device)
            half = (t % steps) < steps // 2
            stats = ((first.sum(-1), (first & half).sum(-1)),)
        if shortest_mode == "both":
            logz = z_direct_count(stream, betas_error, valid=valid,
                                  with_shortest=True)
        else:
            logz = z_direct_count(stream, betas_error, valid=valid,
                                  shortest_only=(shortest_mode == "only"))
        return _percentages(logz, shortest_mode) + stats

    def run(class_states, seed, betas_sampling, betas_error):
        return reduce(sample(class_states, seed, betas_sampling), betas_error)

    run.sample = sample
    run.reduce = reduce
    return run


@functools.lru_cache(maxsize=None)
def _get_stdc_stream_fn(spec: CodeSpec, droplets: int, steps: int,
                        randomize: bool, shortest_mode: str,
                        conv_mult: float, engine: str, with_stats: bool,
                        equal_betas: bool, capacity: int, window: int):
    """Streaming (bounded-memory) variant of ``_get_stdc_fn``
    (stdc.py:123-201): ``run(...) -> (distr, logz) [+ ((n_unique,
    n_unique_half, overflow),)] + (overflow, max_kept, min_rank, kovf)``,
    each (B, K).  Every window of ``window`` steps is one sampler call (one
    kernel launch on the card) and is sort-merged into a per-(B, K) buffer
    of the ``capacity`` lowest-weight unique chains.  Z is exact whenever
    the buffer never overflows; otherwise only chains of Boltzmann weight
    < exp(-max_kept) are dropped (streaming.py's invariant)."""
    shortest_mode = _mode(shortest_mode)
    engine = resolve_engine(engine, "counting")

    def run(class_states, seed, betas_sampling, betas_error):
        B, K, nq = class_states.shape
        R = B * K
        states, samp_seed = class_droplets(spec, class_states, seed,
                                           droplets, randomize)
        chunk = make_chunk_sampler(spec, R, droplets, betas_sampling,
                                   _iters(engine), equal_betas, engine)
        seeds = step_seeds(samp_seed, steps).to(class_states.device)
        _, st, cm = streaming_scan(
            chunk, states.reshape(R * droplets, nq), seeds,
            steps=steps, window=window,
            # a row never holds more unique chains than its samples, so a
            # wider buffer only adds sentinels to every merge
            capacity=min(capacity, droplets * steps),
            rank_fn=lambda nxyz: _weighted_length(nxyz, betas_error),
            nq=nq, R=R, D=droplets, conv_mult=conv_mult,
            track_occupancy=False,
        )
        kovf = (cm.kovf.any(-1) if cm is not None
                else torch.zeros_like(st.overflow)).reshape(B, K)
        stats = ()
        if with_stats:
            # overflow goes with the saturation counts: after eviction,
            # re-discovered chains count again, so (u_tot, u_half)
            # overstate saturation on overflowed rows
            stats = ((st.n_unique.reshape(B, K),
                      st.n_unique_half.reshape(B, K),
                      st.overflow.reshape(B, K)),)
        extras = (st.overflow.reshape(B, K), st.max_kept.reshape(B, K),
                  st.r.amin(-1).reshape(B, K), kovf)
        if shortest_mode == "both":
            logz = tuple(z.reshape(B, K)
                         for z in logz_from_stream(st, with_shortest=True))
        else:
            logz = logz_from_stream(
                st, shortest_only=(shortest_mode == "only")).reshape(B, K)
        return _percentages(logz, shortest_mode) + stats + extras

    return run


def _pick_stream_window(droplets: int, steps: int) -> int:
    """Window size so each merge folds ~4k candidates (sort efficiency)
    without exceeding the step budget (stdc.py:204-207)."""
    return int(np.clip(4096 // max(droplets, 1), 64, max(steps, 64)))


def _as_states(states, device: torch.device) -> torch.Tensor:
    """uint8 states on ``device`` from a numpy array or a tensor."""
    if isinstance(states, torch.Tensor):
        return states.to(device=device, dtype=torch.uint8)
    return torch.tensor(np.asarray(states, np.uint8), device=device)


def stdc_run(
    spec: CodeSpec,
    class_states,  # (B, K, nq) per-class seeds, numpy or tensor
    betas_sampling: np.ndarray,  # (3,)
    betas_error: np.ndarray,  # (3,)
    droplets: int = 10,
    steps: int = 20000,
    randomize: bool = True,
    shortest_only: bool = False,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    shortest_mode: Optional[str] = None,
    metrics=None,
    stream="auto",
    stream_capacity: int = 4096,
    stream_window: Optional[int] = None,
    *,
    device="cuda",
):
    """Generic STDC engine (stdc.py:210-287) on ``device``; returns numpy
    (distr (B, K) percentages, logz (B, K)), or ((full, shortest), logz)
    with ``shortest_mode="both"``.  ``stream`` picks the path ("auto":
    streamed once the materialised stream would pass 1 GiB);
    ``stream_capacity`` and ``stream_window`` size the streamed one.  The
    streamed path warns when its buffers dropped more than a negligible
    tail (``warn_stream_overflow``, ``warn_conv_mult_overflow``);
    ``metrics`` (a ``utils.metrics.MetricsLogger``) gets one ``stdc_run``
    record."""
    device = resolve_device(device)
    resolve_engine(engine, "counting")
    mode = shortest_mode or ("only" if shortest_only else "off")
    # uniform sampling betas (scalar-p depolarizing chains, the common
    # case) take the sweep kernel's total-count branch
    bs_np = np.asarray(betas_sampling, np.float32)
    eq_b = bool(bs_np[0] == bs_np[1] == bs_np[2])
    seeds = _as_states(class_states, device)
    B, K = seeds.shape[0], seeds.shape[1]
    streaming = should_stream(stream, B * K, droplets, steps)
    if streaming:
        fn = _get_stdc_stream_fn(
            spec, droplets, steps, randomize, mode, conv_mult, engine,
            metrics is not None, eq_b, stream_capacity,
            stream_window or _pick_stream_window(droplets, steps),
        )
    else:
        fn = _get_stdc_fn(spec, droplets, steps, randomize, mode, conv_mult,
                          engine, with_stats=metrics is not None,
                          equal_betas=eq_b)
    out = fn(
        seeds, seed,
        torch.as_tensor(bs_np, device=device),
        torch.as_tensor(np.asarray(betas_error, np.float32), device=device),
    )
    distr, logz = out[0], out[1].cpu().numpy()
    overflow = None
    if streaming:
        # the host reads the buffers' flags once, at the end of the decode
        overflow, max_kept, min_rank, kovf = (a.cpu().numpy()
                                              for a in out[-4:])
        warn_stream_overflow(overflow, max_kept, min_rank, droplets * steps,
                             "STDC", stream_capacity)
        if conv_mult:
            warn_conv_mult_overflow(kovf, "STDC", CONV_MULT_UNIQUE_CAP)
    if metrics is not None:
        u_tot, u_half = (a.cpu().numpy() for a in out[2][:2])
        late = (u_tot - u_half) / np.maximum(u_tot, 1)  # second-half share
        metrics.log(
            "stdc_run",
            n_samples=droplets * steps,
            droplets=droplets,
            unique_mean=float(u_tot.mean()),
            unique_min=int(u_tot.min()),
            unique_max=int(u_tot.max()),
            late_discovery_mean=float(late.mean()),
            late_discovery_max=float(late.max()),
            # saturation stats overstate on overflowed rows (re-discovered
            # evicted chains count again); consumers discount via this flag
            overflow_rows=int(overflow.sum()) if overflow is not None else 0,
        )
    if mode == "both":
        return (distr[0].cpu().numpy(), distr[1].cpu().numpy()), logz
    return distr.cpu().numpy(), logz


def _class_seeds(spec: CodeSpec, init_states: torch.Tensor) -> torch.Tensor:
    """(B, nq) -> (B, K, nq) one seed per equivalence class (the vectorised
    to_class loop of decoders.py:285-288); (B, K, nq) warm starts pass."""
    if init_states.ndim == 3:
        return init_states
    return all_class_states(spec, init_states).movedim(0, 1).contiguous()


def STDC(
    spec: CodeSpec,
    init_states,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    metrics=None,
    stream="auto",
    stream_capacity: int = 4096,
    *,
    stream_window: Optional[int] = None,
    device="cuda",
) -> np.ndarray:
    """Depolarizing STDC (decoders.py:268-322).  ``init_states`` is (B, nq)
    (random start; droplets are rained) or (B, K, nq) warm starts (no rain,
    decoders.py:277-279), numpy or a tensor.  Returns (B, K) float32
    percentages.  ``stream``: "auto" switches to the bounded-memory
    streaming reduction once the materialised sample stream would exceed
    ~1 GiB, so the reference's default budget (droplets=10 x steps=20000)
    runs at any batch; True/False force a path.  ``stream_window`` (steps
    per window, one kernel launch each) defaults to
    ``_pick_stream_window``."""
    p_sampling = p_sampling or p_error
    device = resolve_device(device)
    states = _as_states(init_states, device)
    distr, _ = stdc_run(
        spec, _class_seeds(spec, states), betas_depolarizing(p_sampling),
        betas_depolarizing(p_error), droplets, steps, states.ndim == 2,
        seed=seed, conv_mult=conv_mult, engine=engine, metrics=metrics,
        stream=stream, stream_capacity=stream_capacity,
        stream_window=stream_window, device=device,
    )
    return distr


def _general_noise_betas(p_xyz, p_sampling):
    """(betas_sampling, betas_error) for the general-noise variants, in
    float64 (stdc.py:342-359).  ``p_sampling`` may be a scalar
    (depolarizing sampling chain) or a length-3 array (xyz sampling chain),
    the reference's Chain/Chain_xyz dispatch (decoders.py:351-354)."""
    if p_sampling is None:
        p_sampling = float(np.sum(p_xyz))
    if np.ndim(p_sampling) == 0:
        bs = betas_depolarizing(float(p_sampling))
    else:
        bs = betas_xyz(*np.asarray(p_sampling))
    # beta_err = -ln((p_i/3)/(1-p_i)) per reference (decoders.py:389)
    p_xyz = np.asarray(p_xyz, dtype=np.float64)
    with np.errstate(divide="ignore"):
        be = -np.log((p_xyz / 3.0) / (1.0 - p_xyz))
    be = np.where(np.isfinite(be), be, 1e30)
    return bs, be


def STDC_general_noise(
    spec: CodeSpec,
    init_states,
    p_xyz: np.ndarray,
    p_sampling=None,
    droplets: int = 10,
    steps: int = 20000,
    shortest_only: bool = False,
    seed: int = 0,
    engine: str = "auto",
    stream="auto",
    *,
    device="cuda",
) -> np.ndarray:
    """General-noise STDC (decoders.py:345-432).  The reference never rains
    the general-noise chains (decoders.py:365-376)."""
    bs, be = _general_noise_betas(p_xyz, p_sampling)
    device = resolve_device(device)
    seeds = _class_seeds(spec, _as_states(init_states, device))
    distr, _ = stdc_run(spec, seeds, bs, be, droplets, steps, False,
                        shortest_only, seed, engine=engine, stream=stream,
                        device=device)
    return distr


def STDC_general_noise_shortest(
    spec: CodeSpec,
    init_states,
    p_xyz: np.ndarray,
    p_sampling=None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream="auto",
    *,
    device="cuda",
):
    """Returns (full distribution, shortest-only distribution), both reduced
    from ONE sampled stream, the reference's single-pass structure
    (decoders.py:490-505)."""
    bs, be = _general_noise_betas(p_xyz, p_sampling)
    device = resolve_device(device)
    seeds = _class_seeds(spec, _as_states(init_states, device))
    (full, short), _ = stdc_run(
        spec, seeds, bs, be, droplets, steps, False, seed=seed,
        shortest_mode="both", engine=engine, stream=stream, device=device,
    )
    return full, short


def STDC_Nall_n_alpha(
    spec: CodeSpec,
    init_states,
    pz_tilde_sampling: float,
    alpha: float,
    pz_tilde: float,
    droplets: int = 1,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream="auto",
    *,
    device="cuda",
) -> np.ndarray:
    """Alpha-noise STDC on n_eff = n_z + alpha (n_x + n_y)
    (decoders.py:510-581): sampling runs at the alpha acceptance for
    pz_tilde_sampling, weights use beta = -ln(pz_tilde); no rain
    (decoders.py:520-536)."""
    b_s = -np.log(pz_tilde_sampling)
    bs = np.array([alpha * b_s, alpha * b_s, b_s])
    b_e = -np.log(pz_tilde)
    be = np.array([alpha * b_e, alpha * b_e, b_e])
    device = resolve_device(device)
    seeds = _class_seeds(spec, _as_states(init_states, device))
    distr, _ = stdc_run(spec, seeds, bs, be, droplets, steps, False,
                        seed=seed, engine=engine, stream=stream, device=device)
    return distr
