"""STRC: single-temperature ratio counting decoder (decoders.py:745-949).

Counterpart of ``mcmc_qec_tpu/decoders/strc.py`` (materialised path).  Z
estimate per class from occupancy statistics of a single-temperature
stream sampled at beta_sampling, on the sampler STDC uses:

    mean_fraction = 0.5 * (N(l0)/m(l0)
                           + N(l1)/m(l1) * exp(-beta_s * (l1 - l0)))
    Z = mean_fraction * sum_n m(n) * exp(-beta_s * l0 + d_beta * n)

with l0/l1 the shortest/next-shortest observed lengths and d_beta =
beta_sampling - beta_error (decoders.py:860-863, 930-946).  All droplets
feed one stream, so droplet merging is the identity.

Runs on ``device`` ("cuda" by default).  Not ported yet
(``NotImplementedError``, ROADMAP.md queue 1): the streaming reduction,
``conv_mult`` and the ``literal``/``sweep`` engines.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..mcmc.ladder import betas_depolarizing
from ..models.base import CodeSpec
from ..ops.engines import resolve_device, resolve_engine
from .counting import make_sampler, occupancy_stats, sample_classes
from .stdc import _CONV_MULT, _STREAM, _as_states, _class_seeds
from .streaming import should_stream


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
def _get_strc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 conv_mult: float = 0.0, engine: str = "auto"):
    """``run(class_states, seed, betas_sampling, beta_s, beta_e) ->
    (distr, logZ)`` on the device of ``class_states``."""
    if conv_mult:
        raise NotImplementedError(_CONV_MULT)
    engine = resolve_engine(engine, "counting")
    # STRC always samples with a depolarizing (equal-beta) chain
    # (decoders.py:835-949), so the total-count branch is always valid
    sampler = make_sampler(spec, steps, iters_per_step=1, engine=engine,
                           equal_betas=True)
    nq = spec.nq

    def run(class_states, seed, betas_sampling, beta_s, beta_e):
        stream = sample_classes(spec, sampler, class_states, seed,
                                betas_sampling, droplets, steps, randomize)
        st = occupancy_stats(stream, nq)  # arrays (B, K, nq+1)
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
    ``stream_capacity`` and ``stream_window`` belong to the streaming path,
    not ported yet."""
    del stream_capacity, stream_window
    p_sampling = p_sampling or p_error
    device = resolve_device(device)
    resolve_engine(engine, "counting")
    if conv_mult:
        raise NotImplementedError(_CONV_MULT)
    states = _as_states(init_states, device)
    seeds = _class_seeds(spec, states)
    B, K = seeds.shape[0], seeds.shape[1]
    if should_stream(stream, B * K, droplets, steps):
        raise NotImplementedError(_STREAM)
    beta_e = float(betas_depolarizing(p_error)[0])
    beta_s = float(betas_depolarizing(p_sampling)[0])
    fn = _get_strc_fn(spec, droplets, steps, states.ndim == 2, conv_mult,
                      engine)
    distr, _ = fn(
        seeds, seed,
        torch.as_tensor(betas_depolarizing(p_sampling), dtype=torch.float32,
                        device=device),
        beta_s, beta_e,
    )
    return distr.cpu().numpy()
