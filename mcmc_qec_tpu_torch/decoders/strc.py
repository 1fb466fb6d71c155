"""STRC: single-temperature ratio counting decoder (decoders.py:745-949).

Counterpart of ``mcmc_qec_tpu/decoders/strc.py``.  Z
estimate per class from occupancy statistics of a single-temperature
stream sampled at beta_sampling, on the sampler STDC uses:

    mean_fraction = 0.5 * (N(l0)/m(l0)
                           + N(l1)/m(l1) * exp(-beta_s * (l1 - l0)))
    Z = mean_fraction * sum_n m(n) * exp(-beta_s * l0 + d_beta * n)

with l0/l1 the shortest/next-shortest observed lengths and d_beta =
beta_sampling - beta_error (decoders.py:860-863, 930-946).  All droplets
feed one stream, so droplet merging is the identity.

Two paths, as in STDC: materialised (one sampler launch, occupancy from
the whole stream) and streamed (``stream=True``, or ``"auto"`` above 1 GiB
of materialised stream: one launch per window; m(n) accumulates exactly
and N(n) comes from a buffer of the ``stream_capacity`` shortest unique
chains, exact below its truncation length).  With the same seed both
paths see the same samples, so without truncation their percentages are
equal.  ``conv_mult`` is the reference's early-stop rule.

Runs on ``device`` ("cuda" by default), on every counting engine
(``decoders/stdc.py``).
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch

from ..mcmc.ladder import betas_depolarizing
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from .counting import (
    class_droplets,
    conv_mult_valid_mask,
    make_chunk_sampler,
    make_sampler,
    occupancy_stats,
    sample_classes,
    step_seeds,
)
from .stdc import _as_states, _class_seeds, _iters, _pick_stream_window
from .streaming import (
    CONV_MULT_UNIQUE_CAP,
    occupancy_from_stream,
    should_stream,
    streaming_scan,
    warn_conv_mult_overflow,
)


def _strc_reduce(m_n, N_n, shortest, next_shortest, beta_s, beta_e, nq):
    """The STRC Z estimate from occupancy statistics (strc.py:32-68);
    inputs have a (..., nq+1) length axis.  Returns (percentages, logZ)."""
    f32 = torch.float32
    dev = m_n.device
    beta_s = torch.as_tensor(beta_s, dtype=f32, device=dev)
    beta_e = torch.as_tensor(beta_e, dtype=f32, device=dev)
    idx_k = torch.arange(nq + 1, dtype=f32, device=dev)
    l0 = shortest.to(f32)
    l1 = next_shortest.to(f32)

    def frac_at(l):
        li = l.to(torch.int64).clamp(0, nq)[..., None]
        N = N_n.gather(-1, li)[..., 0]
        m = m_n.gather(-1, li)[..., 0]
        return N.to(f32) / m.to(f32).clamp(min=1.0)

    sf = frac_at(l0)
    nsf = frac_at(l1)
    mean_fraction = torch.where(
        next_shortest <= nq,
        0.5 * (sf + nsf * torch.exp(-beta_s * (l1 - l0))),
        sf,
    )
    d_beta = beta_s - beta_e
    # log of sum_n m(n) exp(-beta_s l0 + d_beta n), stably
    logterm = torch.where(
        m_n > 0,
        torch.log(m_n.to(f32).clamp(min=1.0)) + d_beta * idx_k,
        -torch.inf,
    )
    mx = logterm.amax(-1)
    logsum = mx + torch.log(torch.exp(logterm - mx[..., None]).sum(-1))
    logZ = torch.log(mean_fraction.clamp(min=1e-30)) - beta_s * l0 + logsum
    return torch.softmax(logZ, -1) * 100.0, logZ


@functools.lru_cache(maxsize=None)
def _get_strc_stream_fn(spec: CodeSpec, droplets: int, steps: int,
                        randomize: bool, conv_mult: float, engine: str,
                        capacity: int, window: int):
    """Bounded-memory STRC (strc.py:71-135): ``run(...) -> (distr, logZ,
    trunc_bad, kovf)``.  Per-length occupancy m(n) accumulates exactly;
    unique-per-length counts N(n) come from the streaming buffer ranked by
    total length, so they are exact below the truncation rank, in
    particular at the shortest and next-shortest lengths the Z estimate
    reads unless ``trunc_bad`` flags the cell."""
    engine = resolve_engine(engine, "counting")
    nq = spec.nq

    def run(class_states, seed, betas_sampling, beta_s, beta_e):
        B, K, _ = class_states.shape
        R = B * K
        states, samp_seed = class_droplets(spec, class_states, seed,
                                           droplets, randomize)
        # STRC's sampling chain is depolarizing: equal betas
        chunk = make_chunk_sampler(spec, R, droplets, betas_sampling,
                                   _iters(engine), True, engine)
        seeds = step_seeds(samp_seed, steps).to(class_states.device)
        _, st, cm = streaming_scan(
            chunk, states.reshape(R * droplets, nq), seeds,
            steps=steps, window=window,
            # a row never holds more unique chains than its samples, so a
            # wider buffer only adds sentinels to every merge
            capacity=min(capacity, droplets * steps),
            rank_fn=lambda nx: nx.sum(-1).to(torch.float32),
            nq=nq, R=R, D=droplets, conv_mult=conv_mult,
            track_occupancy=True,
        )
        kovf = (cm.kovf.any(-1) if cm is not None
                else torch.zeros_like(st.overflow)).reshape(B, K)
        occ = occupancy_from_stream(st, nq)
        distr, logZ = _strc_reduce(
            occ.m_n.reshape(B, K, nq + 1), occ.N_n.reshape(B, K, nq + 1),
            occ.shortest.reshape(B, K), occ.next_shortest.reshape(B, K),
            beta_s, beta_e, nq,
        )
        # N(n) is exact only strictly below the truncation rank, and the Z
        # estimate reads N at the shortest and next-shortest lengths
        trunc_bad = (torch.isfinite(occ.trunc_at)
                     & (occ.trunc_at <= occ.next_shortest.to(torch.float32))
                     ).reshape(B, K)
        return distr, logZ, trunc_bad, kovf

    return run


@functools.lru_cache(maxsize=None)
def _get_strc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 conv_mult: float = 0.0, engine: str = "auto"):
    """``run(class_states, seed, betas_sampling, beta_s, beta_e) ->
    (distr, logZ)`` on the device of ``class_states``."""
    engine = resolve_engine(engine, "counting")
    # STRC always samples with a depolarizing (equal-beta) chain
    # (decoders.py:835-949), so the total-count branch is always valid
    sampler = make_sampler(spec, steps, iters_per_step=_iters(engine),
                           engine=engine, equal_betas=True)
    nq = spec.nq

    def run(class_states, seed, betas_sampling, beta_s, beta_e):
        stream = sample_classes(spec, sampler, class_states, seed,
                                betas_sampling, droplets, steps, randomize)
        valid = None
        if conv_mult:
            B, K, N = stream.keys.shape[:3]
            n_tot = stream.n_xyz.sum(-1).to(torch.float32)
            valid = conv_mult_valid_mask(
                stream.keys.reshape(B, K, droplets, steps, 2),
                n_tot.reshape(B, K, droplets, steps), conv_mult, steps,
            ).reshape(B, K, N)
        st = occupancy_stats(stream, nq, valid=valid)  # arrays (B, K, nq+1)
        return _strc_reduce(st.m_n, st.N_n, st.shortest, st.next_shortest,
                            beta_s, beta_e, nq)

    return run


def STRC(
    spec: CodeSpec,
    init_states,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    stream="auto",
    stream_capacity: int = 4096,
    stream_window: Optional[int] = None,
    *,
    device="cuda",
):
    """Returns (B, K) float32 percentages (decoders.py:835-949).
    ``init_states`` is (B, nq) (rained droplets) or (B, K, nq) warm starts.
    ``stream``: "auto" switches to the bounded-memory streaming reduction
    once the materialised sample stream would exceed ~1 GiB; True/False
    force a path.  The streamed path warns when its occupancy buffer
    truncated at or below the next-shortest length
    (``_warn_occupancy_truncation``) and, with ``conv_mult``, when the
    early-stop rule's key buffer overflowed."""
    p_sampling = p_sampling or p_error
    device = resolve_device(device)
    resolve_engine(engine, "counting")
    states = _as_states(init_states, device)
    seeds = _class_seeds(spec, states)
    B, K = seeds.shape[0], seeds.shape[1]
    beta_e = float(betas_depolarizing(p_error)[0])
    beta_s = float(betas_depolarizing(p_sampling)[0])
    streaming = should_stream(stream, B * K, droplets, steps)
    if streaming:
        fn = _get_strc_stream_fn(
            spec, droplets, steps, states.ndim == 2, conv_mult, engine,
            stream_capacity,
            stream_window or _pick_stream_window(droplets, steps),
        )
    else:
        fn = _get_strc_fn(spec, droplets, steps, states.ndim == 2, conv_mult,
                          engine)
    out = fn(
        seeds, seed,
        torch.as_tensor(betas_depolarizing(p_sampling), dtype=torch.float32,
                        device=device),
        beta_s, beta_e,
    )
    if streaming:
        _warn_occupancy_truncation(out[2].cpu().numpy(), "STRC",
                                   stream_capacity)
        if conv_mult:
            warn_conv_mult_overflow(out[3].cpu().numpy(), "STRC",
                                    CONV_MULT_UNIQUE_CAP)
    return out[0].cpu().numpy()


def _warn_occupancy_truncation(trunc_bad, name: str, capacity: int) -> None:
    """Streaming occupancy keeps only the ``capacity`` shortest unique
    chains per row; if that buffer truncated at or below the next-shortest
    length, the Z estimate's N(l0)/N(l1) undercount (strc.py:238-255).
    The results are then biased, not silently: warn with the cell count."""
    bad = int(trunc_bad.sum())
    if bad:
        warnings.warn(
            f"{name}: occupancy buffer (stream_capacity={capacity}) "
            f"truncated at/below the next-shortest length in {bad} "
            f"(row, class) cells — unique counts there undercount; "
            f"raise stream_capacity or use stream=False",
            RuntimeWarning,
            stacklevel=3,
        )
