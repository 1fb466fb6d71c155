"""On-device unique-chain counting and occupancy statistics.

Counterpart of ``mcmc_qec_tpu/decoders/counting.py``.  Every chain visit is
recorded on the device as a 64-bit content key (two 32-bit universal
hashes, ``ops/pauli.py::pack_key``, held as int64 values in [0, 2**32))
plus per-Pauli counts; a sort along the sample axis marks first
occurrences and segment reductions produce:

- Z_DC       = sum over *unique* chains of exp(-beta_err . n_xyz)   (STDC)
- m(n), N(n) = total / unique observations per length               (STRC)
- shortest-set statistics                                           (STRC)

Sorting: JAX's two-key lexicographic sort over the uint32 halves becomes
one stable ``torch.sort`` of the int64 key ``(k0 - 2**31) * 2**32 + k1``,
which is exact and orders like (k0, k1), so sorted positions and tie
order (time order) equal ``jnp.lexsort``'s.  The float sums of the
reductions run in torch's order, not XLA's, so log Z agrees with the JAX
package to float32 rounding, not bit for bit.

A ``valid`` mask (the ``conv_mult`` early-stop rule,
``conv_mult_valid_mask``) restricts the counts to the un-masked samples.
The bounded-memory form of the same reductions is ``decoders/streaming.py``.
The samplers record through the sweep kernel's recording launch
(``pallas``, ``sweep``) or the literal update (``literal``, ``fused``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.base import CodeSpec
from ..ops.engines import resolve_engine
from ..ops.metropolis import make_chain_update
from ..ops.pauli import (
    apply_stabilizers_uniform,
    count_errors_xyz,
    make_hash_mults,
    pack_key,
)
from ..ops.sweep import make_recording_sweep


class SampleStream(NamedTuple):
    """Recorded chain visits, leading axes (..., n_samples)."""

    keys: torch.Tensor  # (..., N, 2) int64 holding the uint32 hash halves
    n_xyz: torch.Tensor  # (..., N, 3) int32


def step_seeds(seed: int, steps: int) -> torch.Tensor:
    """The (steps,) int64 per-step kernel seeds of a sampling loop under
    ``seed``, drawn on a CPU ``torch.Generator`` so nothing waits for the
    device.  The streaming path draws the same seeds and hands each window
    its slice, so both paths sample the same chains."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**31 - 1, (steps,), generator=gen)


def _literal_recording(spec: CodeSpec, iters_per_step: int):
    """``fn(states (N, nq) u8, seeds, betas) -> (states, keys (N, steps, 2)
    int64, counts (N, steps, 3) int32)`` on the literal engine: per seed,
    ``iters_per_step`` proposals drawn from a generator on the states'
    device seeded with it (``ops/metropolis.py``), then the chains'
    ``pack_key`` and ``count_errors_xyz`` (counting.py:91-107)."""
    update = make_chain_update(spec, iters_per_step)
    mults = make_hash_mults(spec).astype(np.int64)

    def fn(states: torch.Tensor, seeds, betas):
        seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu().tolist()
        device = states.device
        N, steps = states.shape[0], len(seeds)
        m = torch.as_tensor(mults, device=device)
        keys = torch.empty((N, steps, 2), dtype=torch.int64, device=device)
        counts = torch.empty((N, steps, 3), dtype=torch.int32, device=device)
        for s, seed in enumerate(seeds):
            gen = torch.Generator(device=device).manual_seed(seed)
            states = update(states, gen, betas)
            keys[:, s] = pack_key(spec, states, m)
            counts[:, s] = count_errors_xyz(states)
        return states, keys, counts

    return fn


@functools.lru_cache(maxsize=None)
def _recording(spec: CodeSpec, steps: int, iters_per_step: int, engine: str,
               equal_betas: bool):
    """The recording loop of a resolved counting ``engine``: the sweep
    kernel's recording launch for ``pallas`` (equal betas as given) and
    ``sweep`` (the per-Pauli form, as the JAX dense sweep always takes),
    the literal update for ``literal`` and ``fused`` (counting.py:91-92)."""
    if engine in ("pallas", "sweep"):
        return make_recording_sweep(spec, steps, iters_per_step,
                                    equal_betas and engine == "pallas")
    return _literal_recording(spec, iters_per_step)


def make_sampler(spec: CodeSpec, steps: int, iters_per_step: int = 5,
                 engine: str = "literal", equal_betas: bool = False):
    """Build ``sample(states, seed, betas) -> (states, SampleStream)``
    (counting.py:39-107).

    Each of ``steps`` recording steps runs ``iters_per_step`` updates over
    every chain and records the chains' content keys and per-Pauli counts
    on the states' device.  ``pallas`` and ``sweep`` (one update is one
    colored sweep): on a CUDA tensor the whole loop is one launch of the
    sweep kernel (``ops/sweep.py::make_recording_sweep``), on a CPU tensor
    its plain version.  ``literal`` and ``fused`` (one update is one
    random-stabilizer proposal): the literal update, plain torch.
    ``states``: (..., nq) u8; stream axes (..., steps).  Per-step seeds are
    ``step_seeds(seed, steps)``.  ``betas`` (3,) f32: pass a tensor on the
    device (a host array is copied once per call).  The defaults are the
    JAX package's (counting.py:39); the decoders pass one sweep per
    recorded step off the literal engine, five proposals on it
    (stdc.py:55)."""
    engine = resolve_engine(engine, "counting")
    sampler = _recording(spec, steps, iters_per_step, engine, equal_betas)

    def sample(states: torch.Tensor, seed: int, betas):
        batch_shape, nq = states.shape[:-1], states.shape[-1]
        flat = states.reshape(-1, nq).contiguous()
        flat, keys, nxyz = sampler(flat, step_seeds(seed, steps), betas)
        return flat.reshape(states.shape), SampleStream(
            keys.reshape(batch_shape + (steps, 2)),
            nxyz.reshape(batch_shape + (steps, 3)),
        )

    return sample


def make_chunk_sampler(spec: CodeSpec, R: int, D: int, betas,
                       iters_per_step: int = 1, equal_betas: bool = False,
                       engine: str = "pallas"):
    """The streaming path's sampler (``streaming.py::streaming_scan``):
    ``chunk(states (R*D, nq), seeds_w) -> (states, keys (R, D, n, 2),
    n_xyz (R, D, n, 3))`` runs ``n = len(seeds_w)`` recording steps, one
    step per seed, over every chain, on the resolved counting ``engine``:
    one launch of the sweep kernel on a CUDA tensor, the plain sampler on a
    CPU tensor (or the literal update).  The chains keep their row order
    from window to window, so with the seeds of ``step_seeds`` the windows
    record what one materialised call records."""

    def chunk(states: torch.Tensor, seeds_w):
        n = len(seeds_w)
        sampler = _recording(spec, n, iters_per_step, engine, equal_betas)
        states, keys, nxyz = sampler(states, seeds_w, betas)
        return states, keys.view(R, D, n, 2), nxyz.view(R, D, n, 3)

    return chunk


def class_droplets(spec: CodeSpec, class_states: torch.Tensor, seed: int,
                   droplets: int, randomize: bool):
    """(states (B, K, droplets, nq), sampling seed): ``droplets`` chains per
    (syndrome, class) seed of ``class_states`` (B, K, nq), rained first when
    ``randomize`` (decoders.py:244-246).  The rain and the sampling seed are
    drawn from ``seed``, the same for the materialised and streamed paths."""
    B, K, nq = class_states.shape
    gen = torch.Generator().manual_seed(int(seed))
    rain_seed, samp_seed = torch.randint(0, 2**62, (2,), generator=gen).tolist()
    states = class_states[:, :, None, :].expand(B, K, droplets, nq).contiguous()
    if randomize:
        rain = torch.Generator(device=states.device).manual_seed(rain_seed)
        states = apply_stabilizers_uniform(spec, states, rain, 0.5)
    return states, samp_seed


def sample_classes(spec: CodeSpec, sampler, class_states: torch.Tensor,
                   seed: int, betas_sampling, droplets: int, steps: int,
                   randomize: bool) -> SampleStream:
    """Run ``droplets`` chains per (syndrome, class) seed of
    ``class_states`` (B, K, nq) through ``sampler`` (built for ``steps``
    steps) and merge each (syndrome, class)'s droplets into one stream
    (B, K, droplets * steps, ...), droplet-major as in the JAX decoders.
    ``randomize`` rains every droplet first (decoders.py:244-246)."""
    B, K, _ = class_states.shape
    states, samp_seed = class_droplets(spec, class_states, seed, droplets,
                                       randomize)
    _, stream = sampler(states, samp_seed, betas_sampling)
    return SampleStream(stream.keys.reshape(B, K, droplets * steps, 2),
                        stream.n_xyz.reshape(B, K, droplets * steps, 3))


def _sort_key(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint32 halves in int64 -> (...,) int64 ordered like the
    pair; exact: (k0 - 2**31) * 2**32 spans [-2**63, 2**63 - 2**32]."""
    return (keys[..., 0] - 2**31) * 2**32 + keys[..., 1]


def _first_of_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where a sorted key differs from its predecessor (and at 0)."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return first


def first_occurrence(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort a (..., N, 2) key stream lexicographically and mark first
    occurrences: (order, first_mask), ``first_mask[i]`` True when sorted key
    i differs from key i-1 (counting.py:112-123)."""
    sk, order = torch.sort(_sort_key(keys), dim=-1, stable=True)
    return order, _first_of_runs(sk)


def chronological_first_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask in *time order* for a (..., N, 2) key stream:
    True at index t iff keys[t] was never seen at an earlier index
    (counting.py:126-135).  The stable sort keeps equal keys in time
    order, as ``jnp.lexsort`` with the time index as last key does."""
    order, first_sorted = first_occurrence(keys)
    return torch.zeros_like(first_sorted).scatter(-1, order, first_sorted)


def conv_mult_valid_mask(keys: torch.Tensor, n: torch.Tensor,
                         conv_mult: float, steps: int,
                         t: Optional[torch.Tensor] = None,
                         step_end: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-sample validity under the reference's shortest-chain extension
    rule (counting.py:138-178; decoders.py:249-263): every *new* chain with
    length <= the running shortest extends the stop point to step *
    conv_mult; sampling ends at the first step with step >= stop and
    step*100 >= steps.  ``keys`` (..., N, 2), ``n`` (..., N) lengths;
    returns (..., N) bool.

    ``t`` optionally gives each sample's step index (default: its position)
    and ``step_end`` marks each step's last sample, the only samples at
    which the rule may break (the PT variants record several rungs per
    step, decoders.py:146-161).

    The JAX package runs the rule as a scan; here it is closed-form, with
    the same float32 arithmetic: the running shortest before a sample is
    an exclusive ``cummin`` of n over first occurrences (a first occurrence
    at or below it is exactly a new shortest), the stop point after a
    sample is conv_mult times the step of the last new shortest so far (a
    ``cummax`` of positions), and a sample is valid while no earlier
    sample broke (an exclusive cumulative OR)."""
    first = chronological_first_occurrence(keys)
    N = n.shape[-1]
    dev = n.device
    pos = torch.arange(N, device=dev)
    tf = (pos if t is None else torch.as_tensor(t, device=dev))
    tf = tf.to(torch.float32).expand(n.shape)
    init = n.amax(-1, keepdim=True) + 1
    running = torch.cummin(torch.where(first, n, init), -1).values
    before = torch.cat([init, running[..., :-1]], -1)
    new_short = first & (n <= before)
    last = torch.cummax(torch.where(new_short, pos, -1), -1).values
    stop = torch.where(last >= 0, tf.gather(-1, last.clamp(min=0)) * conv_mult,
                       torch.tensor(float(steps), dtype=torch.float32,
                                    device=dev))
    breaks = (tf >= stop) & (tf * 100 >= steps)
    if step_end is not None:
        breaks = breaks & torch.as_tensor(step_end, device=dev)
    broken = torch.cumsum(breaks.to(torch.int32), -1) > 0
    valid = torch.ones_like(broken)
    valid[..., 1:] = ~broken[..., :-1]
    return valid


def _sorted_first(keys: torch.Tensor, valid: Optional[torch.Tensor]):
    """(order, first) of a (R, N, 2) stream sorted by key: ``first`` marks
    each key's first sample, or with ``valid`` (R, N) its first valid
    sample (counting.py:222-232: valid samples sort ahead within a key,
    so a key counts iff one of its samples is valid)."""
    if valid is None:
        sk, order = torch.sort(_sort_key(keys), dim=-1, stable=True)
        return order, _first_of_runs(sk)
    # (key, invalid) lexicographically: stable sort on the minor key, then
    # stable sort on the major one
    _, by_valid = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True)
    k = _sort_key(keys).gather(-1, by_valid)
    sk, o2 = torch.sort(k, dim=-1, stable=True)
    order = by_valid.gather(-1, o2)
    return order, _first_of_runs(sk) & valid.gather(-1, order)


def _weighted_length(n_xyz: torch.Tensor, betas) -> torch.Tensor:
    """sum_i beta_i * n_i with 0 * inf := 0 (p_i = 0 handling,
    decoders.py:406-417)."""
    b = torch.as_tensor(betas, dtype=torch.float32, device=n_xyz.device)
    terms = torch.where(n_xyz > 0, n_xyz.to(torch.float32) * b, 0.0)
    return terms.sum(-1)


def z_direct_count(
    stream: SampleStream,
    betas_error,
    shortest_only: bool = False,
    valid=None,
    with_shortest: bool = False,
):
    """log Z_E = logsumexp over unique chains of -beta_err . n_xyz
    (counting.py:188-258; decoders.py:317-318, 406-417).  With
    ``shortest_only`` only chains within ~1e-5 of the minimal weighted
    length contribute; ``with_shortest`` returns (log Z, log Z_shortest)
    from the one sorted stream.  ``valid`` (..., N) restricts the count to
    un-masked samples (the conv_mult rule).  Vectorised over leading axes:
    returns log Z (...,) f32."""
    lead, N = stream.keys.shape[:-2], stream.keys.shape[-2]
    keys = stream.keys.reshape(-1, N, 2)
    w_all = _weighted_length(stream.n_xyz.reshape(-1, N, 3), betas_error)
    order, first = _sorted_first(
        keys, None if valid is None else valid.reshape(-1, N))
    w = w_all.gather(-1, order)
    neg = -w

    def reduce(mask):
        m = torch.where(mask, neg, -torch.inf).amax(-1)
        s = torch.where(mask, torch.exp(neg - m[:, None]), 0.0).sum(-1)
        return (m + torch.log(s)).reshape(lead)

    if shortest_only or with_shortest:
        wmin = torch.where(first, w, torch.inf).amin(-1, keepdim=True)
        # jnp.isclose(w, wmin, rtol=1e-5, atol=1e-8)
        short = first & ((w - wmin).abs() <= 1e-8 + 1e-5 * wmin.abs())
        if with_shortest:
            return reduce(first), reduce(short)
        return reduce(short)
    return reduce(first)


class OccupancyStats(NamedTuple):
    """Per-length occupancy of a stream (arrays indexed by total length n)."""

    m_n: torch.Tensor  # (..., nq+1) total observations per length
    N_n: torch.Tensor  # (..., nq+1) unique chains per length
    shortest: torch.Tensor  # (...,) minimal observed length
    next_shortest: torch.Tensor  # (...,) second-smallest length (or nq+1)


def occupancy_stats(stream: SampleStream, nq: int, valid=None) -> OccupancyStats:
    """m(n), N(n) and shortest/next-shortest lengths (counting.py:270-307;
    STRC machinery, decoders.py:597-623, 768-827), over the samples of
    ``valid`` (..., N) when given.  int32 outputs."""
    lead, N = stream.keys.shape[:-2], stream.keys.shape[-2]
    keys = stream.keys.reshape(-1, N, 2)
    n_all = stream.n_xyz.reshape(-1, N, 3).sum(-1)  # int64
    v = None if valid is None else valid.reshape(-1, N)
    order, first = _sorted_first(keys, v)
    i32 = torch.int32
    zeros = torch.zeros((keys.shape[0], nq + 2), dtype=i32, device=keys.device)
    seen = torch.ones_like(n_all, dtype=i32) if v is None else v.to(i32)
    m_n = zeros.scatter_add(-1, n_all, seen)[:, : nq + 1]
    N_n = zeros.scatter_add(-1, n_all.gather(-1, order),
                            first.to(i32))[:, : nq + 1]
    idx = torch.arange(nq + 1, dtype=i32, device=keys.device)
    has = m_n > 0
    shortest = torch.where(has, idx, nq + 1).amin(-1)
    nxt = torch.where(has & (idx > shortest[:, None]), idx, nq + 1).amin(-1)
    return OccupancyStats(
        m_n.reshape(lead + (nq + 1,)),
        N_n.reshape(lead + (nq + 1,)),
        shortest.reshape(lead),
        nxt.reshape(lead),
    )


def unique_count_in_shortest(stream: SampleStream,
                             nq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(#unique chains at the shortest length, #unique at next shortest)."""
    stats = occupancy_stats(stream, nq)
    lead = stats.shortest.shape
    idx = stats.shortest.reshape(-1).long()
    nxt = stats.next_shortest.reshape(-1).long()
    N_flat = stats.N_n.reshape(-1, nq + 1)
    rows = torch.arange(len(idx), device=N_flat.device)
    n_short = N_flat[rows, idx.clamp(0, nq)]
    n_next = torch.where(nxt <= nq, N_flat[rows, nxt.clamp(0, nq)], 0)
    return n_short.reshape(lead), n_next.reshape(lead)
