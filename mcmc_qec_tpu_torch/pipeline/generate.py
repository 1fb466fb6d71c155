"""Batch data generation.

Counterpart of ``mcmc_qec_tpu/pipeline/generate.py`` (itself the batched
redesign of generate_data.py:20-269 and
generate_data_noise_models.py:17-195): whole batches of syndromes are
sampled, warm-started and decoded on ``cfg.device`` (the card unless the
config asks for ``"cpu"``), with periodic dataset checkpoints, per-batch
PTEQ snapshots and ``fixed_errors`` early stop.

Method dispatch is the JAX package's (generate.py:81-234), with its seed
offsets, its noise-model conversions (biased -> alpha for PTEQ,
generate_data.py:147-150; depolarizing -> uncorrelated p_xyz,
generate_data_noise_models.py:203-209) and its ``pallas -> sweep`` mapping
for PTEQ, PTDC and PTRC.  Errors are drawn from a ``torch.Generator`` on
the device seeded from ``(cfg.seed, done)`` by ``error_seed``, in place of
``fold_in(PRNGKey(seed), done)``; the random-logical warm start from one
seeded with ``seed ^ 0x5EED``.  The matcher and the true classes are host
numpy: states come to the host once a batch, warm starts go to the device
once, and the distributions come back once.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..decoders import (
    PTDC,
    PTEQ,
    PTEQ_alpha,
    PTEQ_alpha_with_shortest,
    PTEQConfig,
    PTRC,
    STDC,
    STDC_general_noise,
    STDC_general_noise_shortest,
    STDC_Nall_n_alpha,
    STRC,
    single_temp,
)
from ..matching import class_sorted_mwpm_batch, regular_mwpm_batch
from ..models import get_spec, np_eq_class
from ..models.base import CodeSpec
from ..models.noise import (
    biased_alpha_equivalent,
    sample_depolarizing,
    sample_xyz,
    xyz_probs_from_alpha,
    xyz_probs_from_biased,
)
from ..ops.engines import resolve_device
from ..ops.pauli import random_logical
from ..utils import profiling
from .config import RunConfig
from .dataset import Dataset

# decoders whose init is one (B, nq) state per syndrome: the matcher's
# (B, 4, nq) class seeds do not fit them
_PTEQ_METHODS = ("PTEQ", "PTEQ_with_shortest")


def _stage(name: str):
    """The span ``pipeline.<name>`` of the recorder (``utils/profiling.py``,
    recorded while a profiler records).  Stages: sample (the device draw),
    to_host (the states' one copy to the host, which waits for the draw),
    truth, warm_start, decode (the decoder call, its result on the host),
    decide, save."""
    return profiling.span(f"pipeline.{name}")


def error_seed(seed: int, done: int) -> int:
    """The 64-bit seed of the error draw of the batch that starts at
    datapoint ``done``: splitmix64's finaliser (a bijection) of the pair
    packed into one word, so distinct pairs (each below 2**32) never share
    a seed, and an ``append=True`` resume draws fresh syndromes."""
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (int(done) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def error_generator(cfg: RunConfig, done: int) -> torch.Generator:
    """The generator, on ``cfg.device``, of the batch starting at
    datapoint ``done``."""
    device = resolve_device(cfg.device)
    return torch.Generator(device=device).manual_seed(error_seed(cfg.seed,
                                                                 done))


def _sample_states(spec: CodeSpec, cfg: RunConfig,
                   generator: torch.Generator) -> torch.Tensor:
    """(cfg.batch, nq) uint8 error states on the generator's device."""
    noise = cfg.noise
    B = (cfg.batch,)
    if noise == "depolarizing":
        return sample_depolarizing(generator, spec, cfg.p_error, B)
    if noise == "biased":
        px, py, pz = xyz_probs_from_biased(cfg.p_error, cfg.eta)
        return sample_xyz(generator, spec, px, py, pz, B)
    if noise == "alpha":
        # p_error is pz_tilde in the alpha scripts (generate_data.py:67-74)
        px, py, pz = xyz_probs_from_alpha(cfg.p_error, cfg.alpha)
        return sample_xyz(generator, spec, px, py, pz, B)
    if noise == "uncorrelated":
        # independent X/Z channels of strength p_u = 1 - sqrt(1-p)
        # (generate_data_noise_models.py:203-209)
        p_u = 1.0 - np.sqrt(1.0 - cfg.p_error)
        p_xz = p_u * (1.0 - p_u)
        p_y = p_u**2
        return sample_xyz(generator, spec, p_xz, p_y, p_xz, B)
    raise ValueError(f"unknown noise {noise!r}")


def sample_errors(spec: CodeSpec, cfg: RunConfig,
                  generator: torch.Generator) -> np.ndarray:
    """Batched error sampling per (code, noise) (generate_data.py:56-118)
    on the generator's device; returns (cfg.batch, nq) uint8 on the host."""
    return _sample_states(spec, cfg, generator).cpu().numpy()


def uncorrelated_p_xyz(p_error: float) -> np.ndarray:
    p_u = 1.0 - np.sqrt(1.0 - p_error)
    return np.array([p_u * (1.0 - p_u), p_u**2, p_u * (1.0 - p_u)])


def _engine_pt(engine: str) -> str:
    """The JAX pipeline's engine for PTEQ, PTDC and PTRC: ``pallas`` runs
    the sweep (generate.py:98, 189-197)."""
    return "sweep" if engine == "pallas" else engine


def decode_batch(spec: CodeSpec, cfg: RunConfig, states,
                 seed: int, metrics=None) -> Tuple[np.ndarray, Callable]:
    """Dispatch a batch to the configured decoder on ``cfg.device``.

    ``states`` is (B, nq) uint8, numpy or a tensor.  Returns
    (distributions (B, K) on the host, decision_fn) where decision_fn maps
    a distribution row to the decoded class (argmax, or argmin for ST —
    generate_data.py:199-203)."""
    method, noise = cfg.method, cfg.noise
    device = resolve_device(cfg.device)
    if cfg.mwpm_init and method in _PTEQ_METHODS:
        # the JAX package passes the (B, 4, nq) seeds to PTEQ, which takes
        # (B, nq), and fails deep in the decode with a broadcast error
        raise ValueError(
            f"mwpm_init=True gives (B, 4, nq) class seeds, one per class; "
            f"{method} takes one (B, nq) start per syndrome: use "
            f"mwpm_init=False for {method}"
        )
    states_d = torch.as_tensor(states, dtype=torch.uint8, device=device)
    B = states_d.shape[0]

    def states_host() -> np.ndarray:
        return states_d.cpu().numpy()

    argmax = lambda d: int(np.argmax(d))
    argmin = lambda d: int(np.argmin(d))

    if method == "eMWPM":
        # shortest total-length class among class-constrained solutions
        # (generate_data.py:210-220)
        out = np.zeros((B, spec.n_classes), dtype=np.float32)
        seeds_all = class_sorted_mwpm_batch(spec, states_host())  # (B, 4, nq)
        lens = (seeds_all != 0).sum(axis=-1)
        out[np.arange(B), lens.argmin(axis=1)] = 100.0
        return out, argmax
    if method == "MWPM":
        out = np.zeros((B, spec.n_classes), dtype=np.float32)
        out[np.arange(B), regular_mwpm_batch(spec, states_host())] = 100.0
        return out, argmax

    # warm start (generate_data.py:126-133): the matcher's class seeds
    # (host, thread-pooled across the batch) or a random logical on the
    # device; either reaches the device once
    with _stage("warm_start"):
        if cfg.mwpm_init:
            assert spec.family == "planar", "mwpm_init requires the planar code"
            init = torch.as_tensor(class_sorted_mwpm_batch(spec, states_host()),
                                   device=device)  # (B, 4, nq)
        else:
            gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
            init = random_logical(spec, states_d, gen)

    pteq_cfg = PTEQConfig(
        Nc=cfg.Nc, SEQ=cfg.SEQ, TOPS=cfg.TOPS, eps=cfg.eps,
        max_steps=cfg.max_steps, iters=cfg.iters, window=cfg.window,
        conv_criteria=cfg.conv_criteria, engine=_engine_pt(cfg.engine),
        # mid-decode resume: one checkpoint stream per batch offset so a
        # preempted generate() resumes the in-flight batch exactly
        ckpt_dir=(
            f"{cfg.ckpt_dir}/batch_{seed}"
            if cfg.ckpt_dir and method in ("PTEQ",)
            else None
        ),
    )
    dev = dict(device=device)

    with _stage("decode"):
        if method == "PTEQ":
            if noise == "depolarizing":
                res = PTEQ(spec, init, cfg.p_error, pteq_cfg, seed=seed,
                           metrics=metrics, **dev)
            elif noise == "biased":
                pz_tilde, alpha = biased_alpha_equivalent(cfg.p_error, cfg.eta)
                res = PTEQ_alpha(spec, init, pz_tilde, alpha, pteq_cfg,
                                 seed=seed, metrics=metrics, **dev)
            elif noise == "alpha":
                res = PTEQ_alpha(spec, init, cfg.p_error, cfg.alpha, pteq_cfg,
                                 seed=seed, metrics=metrics, **dev)
            else:
                raise ValueError(f"PTEQ does not support noise {noise!r}")
            return res.distribution.astype(np.float32), argmax
        if method == "PTEQ_with_shortest":
            # three concatenated distributions; failures scored on the
            # first K (generate_data.py:167-173)
            assert noise == "alpha"
            res = PTEQ_alpha_with_shortest(
                spec, init, cfg.p_error, cfg.alpha, pteq_cfg, seed=seed, **dev
            )
            distr = np.concatenate(
                [
                    res.distribution.astype(np.float32),
                    res.shortest_boltzmann.astype(np.float32),
                    res.shortest_counts.astype(np.float32),
                ],
                axis=1,
            )
            return distr, lambda d: int(np.argmax(d[: spec.n_classes]))
        if method == "all":
            # ST + STDC + STRC concatenated
            # (generate_data_noise_models.py:112-123), independent streams
            d1 = single_temp(spec, init, cfg.p_error, cfg.steps, seed=seed,
                             **dev)
            d2 = STDC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                      cfg.steps, seed=seed + 1_000_003, **dev)
            d3 = STRC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                      cfg.steps, seed=seed + 2_000_003, **dev)
            distr = np.concatenate([d1, d2, d3], axis=1).astype(np.float32)
            K = spec.n_classes
            return distr, lambda d: int(np.argmax(d[K : 2 * K]))
        if method == "shortest_comparison":
            # STDC depolarizing, its shortest-only truncation, STDC
            # uncorrelated and ITS truncation, each pair from ONE sampled
            # stream (plot_uncorrelated.py:149-197, decoders.py:490-505)
            p3 = np.full(3, cfg.p_error / 3.0)
            d1, d1s = STDC_general_noise_shortest(
                spec, init, p3, cfg.p_sampling, cfg.droplets, cfg.steps,
                seed=seed, **dev,
            )
            d2, d2s = STDC_general_noise_shortest(
                spec, init, uncorrelated_p_xyz(cfg.p_error), cfg.p_sampling,
                cfg.droplets, cfg.steps, seed=seed + 1_000_003, **dev,
            )
            distr = np.concatenate([d1, d1s, d2, d2s],
                                   axis=1).astype(np.float32)
            return distr, lambda d: int(np.argmax(d[: spec.n_classes]))
        if method == "uncorrelated_comparison":
            # MWPM one-hot + STDC_general_noise; failures scored on the
            # STDC part (generate_data_noise_models.py:141-153)
            d1 = np.zeros((B, spec.n_classes), dtype=np.float32)
            d1[np.arange(B), regular_mwpm_batch(spec, states_host())] = 100.0
            d2 = STDC_general_noise(
                spec, init, uncorrelated_p_xyz(cfg.p_error), cfg.p_sampling,
                cfg.droplets, cfg.steps, seed=seed, **dev,
            ).astype(np.float32)
            distr = np.concatenate([d1, d2], axis=1)
            K = spec.n_classes
            return distr, lambda d: int(np.argmax(d[K : 2 * K]))
        if method in ("PTDC", "PTRC"):
            fn = PTDC if method == "PTDC" else PTRC
            d = fn(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                   cfg.Nc, cfg.steps, seed=seed,
                   engine=_engine_pt(cfg.engine), **dev)
            return d.astype(np.float32), argmax
        if method == "STDC":
            if noise in ("depolarizing",):
                d = STDC(spec, init, cfg.p_error, cfg.p_sampling,
                         cfg.droplets, cfg.steps, seed=seed,
                         engine=cfg.engine, metrics=metrics, **dev)
            elif noise == "uncorrelated":
                d = STDC_general_noise(spec, init,
                                       uncorrelated_p_xyz(cfg.p_error),
                                       cfg.p_sampling, cfg.droplets,
                                       cfg.steps, seed=seed, **dev)
            else:
                raise ValueError(f"STDC does not support noise {noise!r}")
            return d.astype(np.float32), argmax
        if method == "STDC_N_n":
            assert noise == "alpha"
            d = STDC_Nall_n_alpha(spec, init, cfg.p_sampling or 0.25,
                                  cfg.alpha, cfg.p_error, cfg.droplets,
                                  cfg.steps, seed=seed, **dev)
            return d.astype(np.float32), argmax
        if method == "ST":
            d = single_temp(spec, init, cfg.p_error, cfg.steps, seed=seed,
                            **dev)
            return d.astype(np.float32), argmin
        if method == "STRC":
            d = STRC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                     cfg.steps, seed=seed, engine=cfg.engine, **dev)
            return d.astype(np.float32), argmax
    raise ValueError(f"unknown method {cfg.method!r}")


# errors a retry cannot help: config and shape bugs, and what is not
# ported (NotImplementedError is a RuntimeError, which is retried)
_NOT_RETRIED = (ValueError, TypeError, AssertionError, KeyError,
                NotImplementedError)


def _decode_with_retry(spec, cfg, states, seed, metrics, progress):
    """decode_batch with host-level failure detection (generate.py:237-266
    of the JAX package).

    Runtime errors are retried up to ``cfg.retries`` times with linear
    backoff, on the same device and engine (a retry never falls back).
    PTEQ batches with ``cfg.ckpt_dir`` resume from their mid-decode
    snapshot; the other decoders rerun with the same seed.  The device is
    resolved first, so a missing card raises at once instead of being
    retried."""
    resolve_device(cfg.device)
    last = None
    for attempt in range(cfg.retries + 1):
        try:
            return decode_batch(spec, cfg, states, seed, metrics=metrics)
        except _NOT_RETRIED:
            raise
        except Exception as e:  # device / runtime failures
            last = e
            if attempt >= cfg.retries:
                break
            if progress:
                progress(
                    f"[generate] decode attempt {attempt + 1} failed "
                    f"({type(e).__name__}: {str(e)[:120]}); retrying in "
                    f"{cfg.retry_wait * (attempt + 1):.0f}s"
                )
            if metrics is not None:
                metrics.log("decode_retry", attempt=attempt,
                            error=str(e)[:200], seed=seed)
            time.sleep(cfg.retry_wait * (attempt + 1))
    raise last


def generate(
    file_path: Optional[str],
    cfg: RunConfig,
    nbr_datapoints: int = 1000,
    progress: Optional[Callable[[str], None]] = print,
    append: bool = False,
) -> Dataset:
    """Generate and decode ``nbr_datapoints`` syndromes (in batches of
    ``cfg.batch``) on ``cfg.device``, checkpointing to ``file_path`` and
    stopping early once ``cfg.fixed_errors`` failures accumulate
    (generate_data.py:258-261).

    With ``append=True`` an existing dataset at ``file_path`` is extended up
    to ``nbr_datapoints`` total (the noise-models script's capacity-capped
    resume, generate_data_noise_models.py:27-46)."""
    resolve_device(cfg.device)
    spec = get_spec(cfg.code, cfg.size)
    if cfg.fixed_errors is not None:
        nbr_datapoints = 10_000_000  # run until enough failures
    qms, distrs, trues = [], [], []
    failed = 0
    done = 0
    if append and file_path and os.path.exists(file_path):
        prev = Dataset.load(file_path)
        if len(prev):
            qms.append(prev.qubit_matrices)
            distrs.append(prev.distributions)
            trues.append(prev.true_classes)
            done = len(prev)
            if done >= nbr_datapoints:
                return prev
    t0 = time.time()
    last_ckpt = 0
    metrics = None
    if cfg.metrics_path:
        from ..utils.metrics import MetricsLogger

        metrics = MetricsLogger(cfg.metrics_path)
    while done < nbr_datapoints:
        n = min(cfg.batch, nbr_datapoints - done)
        # the draw is seeded from `done`, so append=True resumes produce
        # fresh, non-duplicated samples
        with _stage("sample"):
            states_d = _sample_states(spec, cfg, error_generator(cfg, done))[:n]
        with _stage("to_host"):
            states = states_d.cpu().numpy()
        with _stage("truth"):
            eq_true = np_eq_class(spec, states)
        distr, decide = _decode_with_retry(spec, cfg, states_d, cfg.seed + done,
                                           metrics, progress)
        if cfg.ckpt_dir:
            # the batch finished: drop its mid-decode checkpoint stream so a
            # later run with a changed config can't collide with it
            shutil.rmtree(
                f"{cfg.ckpt_dir}/batch_{cfg.seed + done}", ignore_errors=True
            )
        with _stage("decide"):
            decisions = np.array([decide(d) for d in distr])
            failed += int((decisions != eq_true).sum())
        qms.append(states.reshape((n,) + spec.state_shape))
        distrs.append(distr)
        trues.append(eq_true.astype(np.int32))
        done += n
        if progress:
            progress(
                f"[generate] {done}/{nbr_datapoints} points, {failed} failed, "
                f"{time.time()-t0:.1f}s"
            )
        if file_path and done - last_ckpt >= cfg.checkpoint_every:
            with _stage("save"):
                _dataset(qms, distrs, trues, cfg).save(file_path)
            last_ckpt = done
        if cfg.fixed_errors is not None and failed >= cfg.fixed_errors:
            break
    ds = _dataset(qms, distrs, trues, cfg)
    if file_path:
        with _stage("save"):
            ds.save(file_path)
    return ds


def _dataset(qms, distrs, trues, cfg) -> Dataset:
    return Dataset(
        qubit_matrices=np.concatenate(qms) if qms else np.zeros((0,)),
        distributions=np.concatenate(distrs) if distrs else np.zeros((0, 0)),
        true_classes=np.concatenate(trues) if trues else np.zeros((0,), np.int32),
        config=cfg,
    )
