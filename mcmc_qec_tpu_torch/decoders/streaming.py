"""Bounded-memory streaming reduction for the counting decoders.

Counterpart of ``mcmc_qec_tpu/decoders/streaming.py``.  The materialised
counting path keeps the whole (B, K, droplets * steps) sample stream on the
device, 28 bytes a sample in the port's form (int64 key halves and int32
counts), so the reference's default budget (droplets=10 x steps=20000,
decoders.py:268) at toric d=9 and B=1024 would need 91.8 GB.  Here the
sampling loop runs in windows of ``window`` recording steps, each one
launch of the sweep kernel on a CUDA tensor with the chains carried from
window to window, and every window's samples are sort-merged into a per-row
buffer of the ``capacity`` lowest-rank unique chains plus O(nq) occupancy
counters.  Peak memory is O(rows * (capacity + droplets * window)),
independent of ``steps``.

Exactness invariant (why bounded eviction loses nothing it shouldn't):
the buffer always holds the ``capacity`` smallest unique chains seen so
far, ordered by (rank, key).  A chain of the updated seen set that ranks
among its ``capacity`` smallest is either in this window or was among the
``capacity`` smallest of the old seen set, i.e. in the buffer; so taking
the ``capacity`` smallest merge candidates keeps exactly the ``capacity``
smallest of the whole stream.  Consequently:

- with rank = Boltzmann weight sum_i beta_err_i n_i (STDC), the final
  buffer holds the ``capacity`` largest contributions to Z = sum_unique
  exp(-w); every dropped unique chain contributes less than
  exp(-``max_kept``) (``overflow`` flags the rows that dropped any);
- with rank = total length n (STRC), unique-per-length counts N(n) are
  exact for every n strictly below the largest kept rank.

Same draws as the materialised decode: the per-step seeds are drawn once
(``counting.py::step_seeds``) and window w gets ``seeds[w*W : (w+1)*W]``;
the sweep kernel's Philox counter is (block, color, sweep within the step,
row), so a streamed decode records the materialised decode's keys and
counts bit for bit.  The last window runs only the steps that remain.

Representation: a buffer entry's key is the int64 sort key of its two
uint32 halves (``counting.py::_sort_key``); ``StreamState.k1``/``k2`` and
``ConvMultState.kbuf`` give the halves as the JAX package holds them.  The
JAX ``_merge_row`` makes two ``lax.sort``s, by (k1, k2) to find duplicates
and by (r, k1, k2) to rank; here one stable sort by key marks duplicates,
the dead entries become (SENTINEL, SENTINEL, +inf), and one stable sort by
r of the key-ordered row orders it by (r, key), as the second sort does.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .counting import _first_of_runs

SENTINEL = 0xFFFFFFFF
# default size of the conv_mult equal-shortest-length key buffer; callers
# that pass streaming_scan a different conv_mult_unique_cap must report
# that value in warn_conv_mult_overflow
CONV_MULT_UNIQUE_CAP = 64
_MASK32 = 0xFFFFFFFF
# the sort key of (SENTINEL, SENTINEL): 2**63 - 1, above every real key
_SENTINEL_KEY = (SENTINEL - 2**31) * 2**32 + SENTINEL


def _pack(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint32 halves in int64 -> (...,) int64 sort key."""
    return (keys[..., 0] - 2**31) * 2**32 + keys[..., 1]


def _unpack(key: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_pack``: (...,) -> (..., 2) int64 halves."""
    return torch.stack([(key >> 32) + 2**31, key & _MASK32], -1)


class StreamState(NamedTuple):
    """Per-row streaming reduction state (leading axis R = output rows)."""

    key: torch.Tensor  # (R, C) int64 unique-chain sort keys (empty: 2**63-1)
    r: torch.Tensor  # (R, C) float32 rank (+inf empty)
    m_n: torch.Tensor  # (R, nq+2) int32 total observations per length
    n_unique: torch.Tensor  # (R,) int32 unique chains discovered (exact
    #                         until overflow; an upper bound after, since
    #                         re-discovered evicted chains count again)
    n_unique_half: torch.Tensor  # (R,) int32 n_unique at the halfway point
    overflow: torch.Tensor  # (R,) bool capacity was ever exceeded
    max_kept: torch.Tensor  # (R,) float32 largest rank kept (inf if not
    #                         full); with rank=w every dropped unique chain
    #                         contributes < exp(-max_kept) to Z

    @property
    def k1(self) -> torch.Tensor:
        """(R, C) first key halves (SENTINEL empty)."""
        return _unpack(self.key)[..., 0]

    @property
    def k2(self) -> torch.Tensor:
        """(R, C) second key halves (SENTINEL empty)."""
        return _unpack(self.key)[..., 1]


def init_stream_state(R: int, capacity: int, nq: int,
                      device="cpu") -> StreamState:
    return StreamState(
        key=torch.full((R, capacity), _SENTINEL_KEY, dtype=torch.int64,
                       device=device),
        r=torch.full((R, capacity), torch.inf, device=device),
        m_n=torch.zeros((R, nq + 2), dtype=torch.int32, device=device),
        n_unique=torch.zeros((R,), dtype=torch.int32, device=device),
        n_unique_half=torch.zeros((R,), dtype=torch.int32, device=device),
        overflow=torch.zeros((R,), dtype=torch.bool, device=device),
        max_kept=torch.full((R,), torch.inf, device=device),
    )


def _merge_row(key, r, nkey, nr):
    """Merge every row's buffer (R, C) with its window candidates (R, S),
    invalid candidates pre-sentineled (key 2**63-1, r=+inf).  Returns the
    new (key, r) of the C smallest (r, key) unique entries per row, and per
    row (n_discovered, overflowed_now, max_kept) (streaming.py:87-112)."""
    C = key.shape[-1]
    # the dels free each temporary as soon as it is used: at toric d=9,
    # B=1024 the candidates are 134M entries, 1.07 GB per int64 copy
    ak = torch.cat([key, nkey], -1)
    ar = torch.cat([r, nr], -1)
    # 1) key sort so duplicates are adjacent (r is a function of the chain
    #    content, so duplicate entries carry identical r)
    sk, order = torch.sort(ak, dim=-1, stable=True)
    del ak
    sr = ar.gather(-1, order)
    del ar, order
    alive = _first_of_runs(sk) & torch.isfinite(sr)
    n_before = torch.isfinite(r).sum(-1, dtype=torch.int32)
    n_alive = alive.sum(-1, dtype=torch.int32)
    rr = torch.where(alive, sr, torch.inf)
    sk = torch.where(alive, sk, _SENTINEL_KEY)
    del sr, alive
    # 2) rank sort of the key-ordered row: (r, key) order, so eviction is
    #    deterministic; then truncate
    rr2, o2 = torch.sort(rr, dim=-1, stable=True)
    del rr
    kept = sk.gather(-1, o2[:, :C])
    if rr2.shape[-1] > C:
        overflowed = torch.isfinite(rr2[:, C])
    else:
        overflowed = torch.zeros_like(n_alive, dtype=torch.bool)
    full = torch.isfinite(rr2[:, C - 1])
    max_kept = torch.where(full, rr2[:, C - 1], torch.inf)
    return (kept, rr2[:, :C].contiguous(), n_alive - n_before, overflowed,
            max_kept)


class ConvMultState(NamedTuple):
    """Per-(row, droplet) state of the reference's shortest-chain extension
    rule (decoders.py:249-263; streaming.py:115-134): every *new* chain with
    length <= the running shortest extends the stop point to
    step*conv_mult; a droplet stops recording at the first step with step
    >= stop and step*100 >= steps.

    Novelty at the current shortest length is tracked exactly through a
    small per-droplet key buffer (cap ``U``) of the distinct chains seen at
    that length; a strictly shorter chain is always new.  If the buffer
    overflows, further equal-length chains count as not-new, which can only
    stop sampling earlier (flagged by ``kovf``)."""

    sh_len: torch.Tensor  # (R, D) int32 current shortest length (init nq+1)
    stop: torch.Tensor  # (R, D) float32 extension point
    broken: torch.Tensor  # (R, D) bool recording stopped
    kkey: torch.Tensor  # (R, D, U) int64 sort keys at the shortest length
    nk: torch.Tensor  # (R, D) int32 occupancy of the key buffer
    kovf: torch.Tensor  # (R, D) bool key buffer overflowed at the shortest

    @property
    def kbuf(self) -> torch.Tensor:
        """(R, D, U, 2) key halves (SENTINEL empty), the JAX layout."""
        return _unpack(self.kkey)


def init_conv_mult(R: int, D: int, U: int, nq: int, steps: int,
                   device="cpu") -> ConvMultState:
    return ConvMultState(
        sh_len=torch.full((R, D), nq + 1, dtype=torch.int32, device=device),
        stop=torch.full((R, D), float(steps), device=device),
        broken=torch.zeros((R, D), dtype=torch.bool, device=device),
        kkey=torch.full((R, D, U), _SENTINEL_KEY, dtype=torch.int64,
                        device=device),
        nk=torch.zeros((R, D), dtype=torch.int32, device=device),
        kovf=torch.zeros((R, D), dtype=torch.bool, device=device),
    )


def _conv_mult_window(cm: ConvMultState, keys: torch.Tensor, n: torch.Tensor,
                      t0: int, conv_mult: float, steps: int):
    """Advance the per-droplet automaton over one window
    (streaming.py:148-198): a loop over the window's steps, each step
    vectorised over (row, droplet).  ``keys`` (R, D, W, 2) int64 halves,
    ``n`` (R, D, W) int32 total lengths, ``t0`` the global index of the
    window's first step.  Returns (new state, valid (R, D, W) bool).

    The step index, its product with ``conv_mult`` and the test
    ``t * 100 >= steps`` are float32, as in the JAX package."""
    sh_len, stop, broken, kkey, nk, kovf = (t.clone() for t in cm)
    U = kkey.shape[-1]
    W = keys.shape[2]
    pk = _pack(keys).permute(2, 0, 1).contiguous()  # (W, R, D)
    nn = n.permute(2, 0, 1).contiguous()
    valid = torch.empty((W,) + sh_len.shape, dtype=torch.bool,
                        device=sh_len.device)
    slots = torch.arange(U, device=sh_len.device)
    f32 = np.float32
    for i in range(W):
        t = f32(t0 + i)
        kk, nt = pk[i], nn[i]
        shorter = nt < sh_len
        in_buf = ((kkey == kk[..., None]) & (slots < nk[..., None])).any(-1)
        new_equal = (nt == sh_len) & ~in_buf & ~kovf
        append = new_equal & (nk < U)
        # append on new_equal (if room), reset the buffer on shorter
        kkey.masked_fill_(shorter[..., None], _SENTINEL_KEY)
        slot = torch.where(shorter, 0, nk).clamp(max=U - 1)[..., None]
        write = (shorter | append)[..., None]
        kkey.scatter_(-1, slot, torch.where(write, kk[..., None],
                                            kkey.gather(-1, slot)))
        ovf_now = new_equal & (nk >= U)
        nk = torch.where(shorter, 1, nk + append.to(torch.int32))
        kovf = torch.where(shorter, False, kovf | ovf_now)
        sh_len = torch.where(shorter, nt, sh_len)
        stop = torch.where(shorter | new_equal, float(t * f32(conv_mult)),
                           stop)
        valid[i] = ~broken
        if t * f32(100) >= f32(steps):
            broken = broken | (stop <= float(t))
    new = ConvMultState(sh_len, stop, broken, kkey, nk, kovf)
    return new, valid.permute(1, 2, 0)


class StreamTiming:
    """Device time of ``streaming_scan``'s parts, summed over windows:
    ``sample`` (the chunk sampler, one sweep-kernel launch a window),
    ``conv_mult`` (the early-stop automaton) and ``merge`` (rank, sentinel,
    sort-merge, occupancy); the PT samplers' ladder steps add ``sweep``
    and ``exchange`` within ``sample`` (``decoders/ptdc.py``).  Off unless ``enabled``; on a CUDA device it
    records CUDA events around each part (no synchronisation until
    ``ms()``); elsewhere it records nothing."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.windows = 0
        self._marks = []  # (part, start event, end event)

    def mark(self, device):
        """A recorded CUDA event, or None when timing is off or the
        device is not a CUDA device."""
        if (not self.enabled or device is None
                or torch.device(device).type != "cuda"):
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, part: str, start, end) -> None:
        if start is not None:
            self._marks.append((part, start, end))

    def ms(self) -> dict:
        """{part: total device ms} over every window timed since reset."""
        out = {}
        for part, a, b in self._marks:
            b.synchronize()
            out[part] = out.get(part, 0.0) + a.elapsed_time(b)
        return out


stream_timing = StreamTiming()


def streaming_scan(
    chunk_sampler: Callable,
    states,
    seeds: torch.Tensor,
    *,
    steps: int,
    window: int,
    capacity: int,
    rank_fn: Callable[[torch.Tensor], torch.Tensor],
    nq: int,
    R: int,
    D: int,
    conv_mult: float = 0.0,
    conv_mult_unique_cap: int = CONV_MULT_UNIQUE_CAP,
    track_occupancy: bool = True,
):
    """Run ``ceil(steps/window)`` sampling windows, folding each into the
    bounded per-row reduction (streaming.py:201-282).

    ``chunk_sampler(states, seeds_w) -> (states, keys (R, D, n, 2) int64,
    n_xyz (R, D, n, 3) int32)`` records one sample per droplet for each of
    the ``n = len(seeds_w)`` per-step seeds of the window, ``seeds[w*window
    : (w+1)*window]`` (the last window gets the steps that remain).
    ``states`` is the chunk sampler's to carry (the chains, or a PT
    ladder's tuple of tensors).
    Droplets are independent chains feeding the same row buffer: the
    droplet fan-in of STDC/STRC, or ladder rungs for PTDC.  ``rank_fn``
    maps n_xyz (..., 3) to the f32 rank (...).

    Returns (states, StreamState, ConvMultState or None).  The
    ConvMultState (None when ``conv_mult`` is 0) carries ``kovf``, the
    equal-shortest-length key-buffer overflow that makes the early-stop
    rule fire sooner than the reference's unbounded dict
    (``warn_conv_mult_overflow``)."""
    if len(seeds) != steps:
        raise ValueError(f"{len(seeds)} seeds for {steps} steps")
    if window < 1 or capacity < 1:
        raise ValueError(f"window={window}, capacity={capacity}: expected "
                         f">= 1")
    n_windows = -(-steps // window)
    half = steps // 2
    st = cm = None
    tm = stream_timing
    # the chain state: a tensor, a tuple of them (a PT ladder's) or
    # anything else (the samples then give the device)
    first = states[0] if isinstance(states, tuple) and states else states
    dev = first.device if isinstance(first, torch.Tensor) else None
    for w in range(n_windows):
        s0 = w * window
        s1 = min(steps, s0 + window)
        a = tm.mark(dev)
        states, keys, n_xyz = chunk_sampler(states, seeds[s0:s1])
        if st is None:
            dev = keys.device
            st = init_stream_state(R, capacity, nq, dev)
            if conv_mult:
                cm = init_conv_mult(R, D, conv_mult_unique_cap, nq, steps,
                                    dev)
        b = tm.mark(dev)
        tm.add("sample", a, b)
        W = s1 - s0
        n_tot = n_xyz.sum(-1, dtype=torch.int32)  # (R, D, W)
        valid = None
        if cm is not None:
            cm, valid = _conv_mult_window(cm, keys, n_tot, s0, conv_mult,
                                          steps)
            c = tm.mark(dev)
            tm.add("conv_mult", b, c)
            b = c
        rank = rank_fn(n_xyz)  # (R, D, W) f32
        S = D * W
        fk = _pack(keys)
        if valid is not None:
            fk = torch.where(valid, fk, _SENTINEL_KEY)
            rank = torch.where(valid, rank, torch.inf)
        key, r, disc, ovf, mk = _merge_row(st.key, st.r, fk.reshape(R, S),
                                           rank.reshape(R, S))
        n_unique = st.n_unique + disc
        m_n = st.m_n
        if track_occupancy:
            # occupancy: bincount every valid observation by total length
            idx = n_tot.to(torch.int64).reshape(R, S)
            ones = (torch.ones_like(idx, dtype=torch.int32) if valid is None
                    else valid.reshape(R, S).to(torch.int32))
            if valid is not None:
                idx = torch.where(valid.reshape(R, S), idx, nq + 1)
            m_n = m_n.scatter_add(-1, idx, ones)
        at_half = (w + 1) * window >= half
        was_before = w * window < half
        n_half = n_unique if (at_half and was_before) else st.n_unique_half
        st = StreamState(key=key, r=r, m_n=m_n, n_unique=n_unique,
                         n_unique_half=n_half, overflow=st.overflow | ovf,
                         max_kept=mk)
        tm.add("merge", b, tm.mark(dev))
        tm.windows += 1
    return states, st, cm


def warn_stream_overflow(overflow: np.ndarray, max_kept: np.ndarray,
                         min_rank: np.ndarray, n_samples: int,
                         name: str, capacity: int,
                         rel_tol: float = 1e-9) -> None:
    """Z truncation observability for the direct-counting stream paths
    (streaming.py:285-316): when a row's buffer overflowed, unique chains
    beyond the ``capacity`` lowest-weight ones were dropped from Z.  Each
    dropped chain contributes < exp(-max_kept) while Z >= exp(-min_rank),
    and at most ``n_samples`` distinct chains can have been dropped, so the
    RELATIVE Z deficit is < n_samples * exp(-(max_kept - min_rank)).  Warn
    only when that bound exceeds ``rel_tol``."""
    rel = stream_deficit_bound(overflow, max_kept, min_rank, n_samples)
    bad = int((rel > rel_tol).sum())
    if bad:
        warnings.warn(
            f"{name}: unique-chain buffer (stream_capacity={capacity}) "
            f"overflowed with a non-negligible dropped tail in {bad} "
            f"(row, class) cells — worst relative Z deficit bound "
            f"{float(rel.max()):.2e}; raise stream_capacity (or use "
            f"stream=False)",
            RuntimeWarning,
            stacklevel=3,
        )


def stream_deficit_bound(overflow, max_kept, min_rank,
                         n_samples: int) -> np.ndarray:
    """Per-cell bound on the relative Z deficit of ``warn_stream_overflow``
    (0 where the buffer never overflowed)."""
    ovf = np.asarray(overflow)
    gap = np.asarray(max_kept, np.float64) - np.asarray(min_rank, np.float64)
    with np.errstate(invalid="ignore"):
        return np.where(ovf, float(n_samples) * np.exp(-np.maximum(gap, 0.0)),
                        0.0)


def warn_conv_mult_overflow(kovf: np.ndarray, name: str, cap: int) -> None:
    """The streaming conv_mult automaton tracks novelty at the running
    shortest length through a bounded key buffer; on overflow further
    equal-length chains count as not-new, so the early-stop rule can fire
    EARLIER than the reference's unbounded dict (streaming.py:319-337)."""
    bad = int(np.asarray(kovf).sum())
    if bad:
        warnings.warn(
            f"{name}: conv_mult shortest-chain key buffer "
            f"(conv_mult_unique_cap={cap}) overflowed in {bad} "
            f"(row, droplet) cells — the extension rule may have stopped "
            f"those droplets earlier than the reference rule; raise "
            f"conv_mult_unique_cap",
            RuntimeWarning,
            stacklevel=3,
        )


# ---------------------------------------------------------------------------
# Reductions from the final buffer
# ---------------------------------------------------------------------------


def logz_from_stream(st: StreamState, shortest_only: bool = False,
                     with_shortest: bool = False):
    """log Z = logsumexp over the kept unique chains of -rank (the STDC
    Boltzmann sum, decoders.py:317-318; streaming.py:345-368), for a stream
    built with rank = weighted length.  Empty buffers yield -inf."""
    fin = torch.isfinite(st.r)
    neg = torch.where(fin, -st.r, -torch.inf)

    def reduce(mask):
        m = torch.where(mask, neg, -torch.inf).amax(-1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        s = torch.where(mask, torch.exp(neg - m_safe), 0.0).sum(-1)
        return m[..., 0] + torch.log(s.clamp(min=1e-30))

    if shortest_only or with_shortest:
        wmin = st.r.amin(-1, keepdim=True)
        # jnp.isclose(r, wmin, rtol=1e-5, atol=1e-8) on the finite entries
        short = fin & ((st.r - wmin).abs() <= 1e-8 + 1e-5 * wmin.abs())
        if with_shortest:
            return reduce(fin), reduce(short)
        return reduce(short)
    return reduce(fin)


class StreamOccupancy(NamedTuple):
    m_n: torch.Tensor  # (R, nq+1) total observations per length
    N_n: torch.Tensor  # (R, nq+1) unique chains per length (exact below
    #                    the truncation rank; see trunc_at)
    shortest: torch.Tensor  # (R,) minimal observed length
    next_shortest: torch.Tensor  # (R,) second-smallest length (nq+1 none)
    trunc_at: torch.Tensor  # (R,) N(n) is exact for n < trunc_at (inf if
    #                         never overflowed)


def occupancy_from_stream(st: StreamState, nq: int) -> StreamOccupancy:
    """m(n), N(n), shortest/next-shortest (the STRC machinery,
    decoders.py:597-623, 768-827; streaming.py:381-401) from a stream built
    with rank = total length n.  int32 counts."""
    R = st.r.shape[0]
    fin = torch.isfinite(st.r)
    n_idx = torch.where(fin, st.r, 0.0).to(torch.int64)
    n_idx = torch.where(fin, n_idx, nq + 1)
    zeros = torch.zeros((R, nq + 2), dtype=torch.int32, device=st.r.device)
    N_n = zeros.scatter_add(-1, n_idx, torch.ones_like(n_idx, dtype=torch.int32))
    N_n = N_n[:, : nq + 1]
    m_n = st.m_n[:, : nq + 1]
    has = m_n > 0
    idx = torch.arange(nq + 1, dtype=torch.int32, device=st.r.device)
    shortest = torch.where(has, idx, nq + 1).amin(-1)
    nxt = torch.where(has & (idx > shortest[:, None]), idx, nq + 1).amin(-1)
    trunc = torch.where(st.overflow, st.max_kept, torch.inf)
    return StreamOccupancy(m_n, N_n, shortest, nxt, trunc)


# ---------------------------------------------------------------------------
# The stream knob
# ---------------------------------------------------------------------------


# materialized-path cost model: 8 key bytes + 12 n_xyz bytes per sample
STREAM_BYTES_PER_SAMPLE = 20
# stream="auto" switches to the bounded-memory path above this many bytes
STREAM_AUTO_BYTES = 1 << 30


def should_stream(stream, rows: int, droplets: int, steps: int) -> bool:
    """Resolve the ``stream`` knob shared by STDC/STRC/PTDC/PTRC:
    "auto" switches on once the materialized sample stream would exceed
    ~1 GiB; True/False force a path.  Any other value is rejected (a
    string like "off" must not silently truthy-enable streaming)."""
    if isinstance(stream, str):
        if stream != "auto":
            raise ValueError(
                f"stream={stream!r}: expected 'auto', True or False"
            )
        return rows * droplets * steps * STREAM_BYTES_PER_SAMPLE \
            > STREAM_AUTO_BYTES
    if not isinstance(stream, (bool, np.bool_, int)):
        raise ValueError(
            f"stream={stream!r}: expected 'auto', True or False"
        )
    return bool(stream)
