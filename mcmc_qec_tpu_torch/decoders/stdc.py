"""STDC: single-temperature direct counting decoders.

Counterpart of ``mcmc_qec_tpu/decoders/stdc.py`` (materialised path).  For
every syndrome, all (class x droplet) chains run in one batch at the
sampling temperature: the whole sampling loop, one colored sweep per
recording step with the visits recorded as content keys and per-Pauli
counts, is one launch of the sweep kernel (``ops/sweep.py``,
``decoders/counting.py::make_sampler``), and Z_E = sum over unique chains of
exp(-beta_err . n_xyz) comes from a sort and a segment logsumexp.

All four reference variants are one engine with two beta vectors:
 - STDC:                    betas_sampling = depolarizing(p_sampling),
                            betas_err = depolarizing(p_error)
 - STDC_general_noise:      vector betas (a scalar p_sampling gives equal
                            sampling betas, decoders.py:351-354)
 - STDC_Nall_n_alpha:       alpha forms (decoders.py:537-581)
Equal sampling betas take the sweep kernel's total-count branch.

Every entry point runs on ``device`` ("cuda" by default; "cpu" runs the
plain sweep).  Not ported yet (``NotImplementedError``, ROADMAP.md queue
1): the streaming reduction (``stream=True``, or ``"auto"`` above 1 GiB of
stream), ``conv_mult``, ``metrics``, and the ``literal``/``sweep`` engines.
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
from .counting import make_sampler, sample_classes, z_direct_count
from .streaming import should_stream

_STREAM = ("the streaming reduction (stream=True, or stream='auto' above "
           "1 GiB of materialised samples) is not ported yet: ROADMAP.md "
           "queue 1")
_CONV_MULT = ("conv_mult (the early-stop rule, conv_mult_valid_mask) is "
              "not ported yet: ROADMAP.md queue 1")
_METRICS = ("metrics / with_stats (saturation statistics) are not ported "
            "yet: ROADMAP.md queue 1")


@functools.lru_cache(maxsize=None)
def _get_stdc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 shortest_mode: str, conv_mult: float = 0.0,
                 engine: str = "auto", with_stats: bool = False,
                 equal_betas: bool = False):
    """``run(class_states (B, K, nq), seed, betas_sampling, betas_error) ->
    (distr, logz)`` on the device of ``class_states``.  ``run.sample`` and
    ``run.reduce`` are its two halves (sampling loop; dedup and Z), which
    ``run`` calls in turn.

    shortest_mode: "off" (full Z), "only" (shortest-truncated Z) or
    "both" (full + shortest from one sampled stream, decoders.py:490-505);
    bools are accepted (False="off", True="only")."""
    if isinstance(shortest_mode, bool):
        shortest_mode = "only" if shortest_mode else "off"
    if conv_mult:
        raise NotImplementedError(_CONV_MULT)
    if with_stats:
        raise NotImplementedError(_METRICS)
    engine = resolve_engine(engine, "counting")
    # one colored sweep per recorded step (stdc.py:55: iters=1 off literal)
    sampler = make_sampler(spec, steps, iters_per_step=1, engine=engine,
                           equal_betas=equal_betas)

    def sample(class_states, seed, betas_sampling):
        return sample_classes(spec, sampler, class_states, seed,
                              betas_sampling, droplets, steps, randomize)

    def reduce(stream, betas_error):
        # normalised percentages via a stable softmax (== Z / sum Z * 100,
        # decoders.py:322)
        if shortest_mode == "both":
            logz, logz_s = z_direct_count(stream, betas_error,
                                          with_shortest=True)
            return ((torch.softmax(logz, -1) * 100.0,
                     torch.softmax(logz_s, -1) * 100.0), logz)
        logz = z_direct_count(stream, betas_error,
                              shortest_only=(shortest_mode == "only"))
        return torch.softmax(logz, -1) * 100.0, logz

    def run(class_states, seed, betas_sampling, betas_error):
        return reduce(sample(class_states, seed, betas_sampling), betas_error)

    run.sample = sample
    run.reduce = reduce
    return run


def _pick_stream_window(droplets: int, steps: int) -> int:
    """Window size so each merge folds ~4k candidates (sort efficiency)
    without exceeding the step budget (for the streaming reduction)."""
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
    with ``shortest_mode="both"``.  ``stream_capacity`` and
    ``stream_window`` belong to the streaming path, not ported yet."""
    del stream_capacity, stream_window
    device = resolve_device(device)
    resolve_engine(engine, "counting")
    mode = shortest_mode or ("only" if shortest_only else "off")
    if metrics is not None:
        raise NotImplementedError(_METRICS)
    if conv_mult:
        raise NotImplementedError(_CONV_MULT)
    # uniform sampling betas (scalar-p depolarizing chains, the common
    # case) take the sweep kernel's total-count branch
    bs_np = np.asarray(betas_sampling, np.float32)
    eq_b = bool(bs_np[0] == bs_np[1] == bs_np[2])
    seeds = _as_states(class_states, device)
    B, K = seeds.shape[0], seeds.shape[1]
    if should_stream(stream, B * K, droplets, steps):
        raise NotImplementedError(_STREAM)
    fn = _get_stdc_fn(spec, droplets, steps, randomize, mode, conv_mult,
                      engine, with_stats=False, equal_betas=eq_b)
    distr, logz = fn(
        seeds, seed,
        torch.as_tensor(bs_np, device=device),
        torch.as_tensor(np.asarray(betas_error, np.float32), device=device),
    )
    logz = logz.cpu().numpy()
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
    device="cuda",
) -> np.ndarray:
    """Depolarizing STDC (decoders.py:268-322).  ``init_states`` is (B, nq)
    (random start; droplets are rained) or (B, K, nq) warm starts (no rain,
    decoders.py:277-279), numpy or a tensor.  Returns (B, K) float32
    percentages."""
    p_sampling = p_sampling or p_error
    device = resolve_device(device)
    states = _as_states(init_states, device)
    distr, _ = stdc_run(
        spec, _class_seeds(spec, states), betas_depolarizing(p_sampling),
        betas_depolarizing(p_error), droplets, steps, states.ndim == 2,
        seed=seed, conv_mult=conv_mult, engine=engine, metrics=metrics,
        stream=stream, stream_capacity=stream_capacity, device=device,
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
