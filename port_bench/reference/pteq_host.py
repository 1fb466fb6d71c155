"""PTEQ's host loop worked out again from each window's summaries.

Given what every window of one decode handed the host (chunk-mean energies,
burn flags, ``tops0``, swap counts, ``since_burn`` and class counts, per row
of the device batch at that window), this replays the decision rules of the
upstream decoder (decoders.py:25-105) as the batched decoder applies them
once a window:

- a syndrome's burn-in ends at its first burned step;
- the error-based criterion compares the mean bottom energy over the second
  and the fourth quarter of its post-burn trace, accepting ``|Q2 - Q4| <
  eps``; ``SEQ`` further arrivals of the top chain while it keeps accepting,
  once ``tops0 >= TOPS``, converge it, and its distribution is its class
  counts over ``since_burn`` at that window;
- once at most ``compact_frac`` of the batch is left unconverged, the batch
  shrinks to the next power of two (at least ``min_compact``) holding the
  survivors, padded with copies of the first;
- after the last window every unconverged syndrome takes its counts then.

The energy history keeps prefix sums at group edges and, past ``max_rows``
edges, every other edge (so quarter edges snap to groups), as the decoder's
bounded history does.  The result is the uint8 floor of the percentages.
"""

from __future__ import annotations

import numpy as np


class History:
    """Prefix sums of the chunk-mean energies at group edges, in the
    decoder's arithmetic: a window's chunk means (float32) are summed in
    float32 within the window and added to the float64 edge before it."""

    def __init__(self, n_cols: int, max_rows: int):
        self.max_rows = max_rows
        self.cum = np.zeros((256, n_cols))
        self.cnt = np.zeros(256, np.int64)
        self.n = 0  # edges 0..n hold values
        self.span = 1

    def _push(self, rows: np.ndarray, cnts: np.ndarray) -> None:
        need = self.n + 1 + len(rows)
        if need > len(self.cnt):
            size = max(need, 2 * len(self.cnt))
            cum = np.zeros((size, self.cum.shape[1]))
            cum[:self.n + 1] = self.cum[:self.n + 1]
            cnt = np.zeros(size, np.int64)
            cnt[:self.n + 1] = self.cnt[:self.n + 1]
            self.cum, self.cnt = cum, cnt
        self.cum[self.n + 1:need] = rows
        self.cnt[self.n + 1:need] = cnts
        self.n = need - 1

    def append(self, e: np.ndarray) -> None:
        i, wc, n = 0, e.shape[0], self.n
        if n and self.cnt[n] - self.cnt[n - 1] < self.span:
            take = min(int(self.span - (self.cnt[n] - self.cnt[n - 1])), wc)
            self.cum[n] += e[:take].sum(axis=0)
            self.cnt[n] += take
            i = take
        nfull, rem = divmod(wc - i, self.span)
        ngrp = nfull + (1 if rem else 0)
        if ngrp:
            if self.span == 1:
                gs, cnts = e[i:], np.ones(ngrp, np.int64)
            else:
                gs = np.empty((ngrp, e.shape[1]))
                if nfull:
                    gs[:nfull] = e[i:i + nfull * self.span].reshape(
                        nfull, self.span, -1).sum(axis=1)
                if rem:
                    gs[nfull] = e[i + nfull * self.span:].sum(axis=0)
                cnts = np.full(ngrp, self.span, np.int64)
                if rem:
                    cnts[-1] = rem
            self._push(self.cum[n] + np.cumsum(gs, axis=0),
                       self.cnt[n] + np.cumsum(cnts))
        while self.n > self.max_rows:
            idx = np.arange(0, self.n + 1, 2)
            if self.n % 2:
                idx = np.append(idx, self.n)
            m = len(idx) - 1
            self.cum[:m + 1] = self.cum[idx]
            self.cnt[:m + 1] = self.cnt[idx]
            self.n = m
            self.span *= 2

    def select(self, sel: np.ndarray) -> None:
        self.cum = np.ascontiguousarray(self.cum[:, sel])

    def accept(self, start, length, eps: float) -> np.ndarray:
        cum, cnt = self.cum[:self.n + 1], self.cnt[:self.n + 1]
        total = int(cnt[-1])
        ln = np.maximum(length, 0)
        edges = np.stack([start + ln // 4, start + ln // 2,
                          start + (3 * ln) // 4, start + ln])
        g = np.searchsorted(cnt, np.clip(edges, 0, total))
        cols = np.arange(cum.shape[1])
        n2 = cnt[g[1]] - cnt[g[0]]
        n4 = cnt[g[3]] - cnt[g[2]]
        q2 = (cum[g[1], cols] - cum[g[0], cols]) / np.maximum(n2, 1)
        q4 = (cum[g[3], cols] - cum[g[2], cols]) / np.maximum(n4, 1)
        return (n2 > 0) & (n4 > 0) & (np.abs(q2 - q4) < eps)


def replay(fetches, B: int, K: int, *, n_windows: int, energy_chunk: int,
           TOPS: int, SEQ: int, eps: float, compact: bool = True,
           compact_frac: float = 0.5, min_compact: int = 128,
           max_rows: int = 4096):
    """The decode's result from its windows' summaries.

    ``fetches`` lists, per window, (energies (W/C, Br), burn_any (Br,),
    burn_first (Br,), tops0 (Br,), swaps (Br, Nc-1), since_burn (Br,),
    eq_count (Br, K)).  Returns (distribution (B, K) uint8, converged (B,),
    steps (B,), tops0 (B,), the row map of each window (the batch position
    of every syndrome, -1 padding), and the batch sizes after each
    compaction).  Raises ``ValueError`` when the decode ran another number
    of windows than these rules stop at (``n_windows`` at most)."""
    C = energy_chunk
    rows = np.arange(B)
    hist = History(B, max_rows)
    burn_start = np.full(B, -1, np.int64)
    conv_start = np.zeros(B, np.int64)
    in_streak = np.zeros(B, bool)
    converged = np.zeros(B, bool)
    distr = np.zeros((B, K))
    steps = np.zeros(B, np.int64)
    tops_at = np.zeros(B, np.int64)
    done_steps = 0
    row_maps, buckets = [], []
    last = None
    stop = len(fetches)
    for w, f in enumerate(fetches):
        if w >= n_windows:
            raise ValueError(f"{len(fetches)} windows ran, the cap is "
                             f"{n_windows}")
        row_maps.append(rows.copy())
        en, ba, bf, tp, _, sb, ec = f
        last = (tp, sb, ec)
        Br = len(rows)
        newly = (burn_start < 0) & ba
        burn_start[newly] = done_steps + bf[newly]
        done_steps += en.shape[0] * C
        hist.append(en)
        real = rows >= 0
        conv_r = np.ones(Br, bool)
        conv_r[real] = converged[rows[real]]
        active = ~conv_r & (tp >= TOPS) & (burn_start >= 0)
        if active.any():
            acc = hist.accept(np.maximum(burn_start, 0) // C, sb // C, eps)
            start = acc & ~in_streak
            conv_start[start] = tp[start]
            in_streak = acc
            done = active & acc & (tp - conv_start >= SEQ)
            if done.any():
                idx = np.nonzero(done)[0]
                o = rows[idx]
                distr[o] = ec[idx] / np.maximum(sb[idx, None], 1)
                steps[o] = done_steps
                tops_at[o] = tp[idx]
                converged[o] = True
        if converged.all():
            stop = w + 1
            break
        # compaction
        if compact and Br > min_compact:
            ridx = np.nonzero(rows >= 0)[0]
            alive = ridx[~converged[rows[ridx]]]
            if 0 < len(alive) <= int(Br * compact_frac):
                nb = max(min_compact, 1 << int(len(alive) - 1).bit_length())
                if nb < Br:
                    sel = np.concatenate([alive, np.repeat(alive[:1],
                                                           nb - len(alive))])
                    hist.select(sel)
                    burn_start = burn_start[sel]
                    conv_start = conv_start[sel]
                    in_streak = in_streak[sel]
                    rows = np.concatenate([rows[alive],
                                           np.full(nb - len(alive), -1)])
                    buckets.append(nb)
    if stop != len(fetches) or (not converged.all()
                                and len(fetches) != n_windows):
        raise ValueError(f"{len(fetches)} windows ran, the rules stop at "
                         f"{stop if converged.all() else n_windows}")
    if not converged.all() and last is not None:
        tp, sb, ec = last
        ridx = np.nonzero(rows >= 0)[0]
        o = rows[ridx]
        m = ~converged[o]
        ridx, o = ridx[m], o[m]
        distr[o] = ec[ridx] / np.maximum(sb[ridx, None], 1)
        steps[o] = done_steps
        tops_at[o] = tp[ridx]
    return ((distr * 100).astype(np.uint8), converged, steps, tops_at,
            row_maps, buckets)
