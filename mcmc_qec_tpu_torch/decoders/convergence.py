"""Error-based PT convergence criterion ("felkriteriet").

Vectorized over the syndrome batch with prefix sums, replacing the per-step
O(T) quarter averages of the reference (decoders.py:93-105,
decoders_biasednoise.py:79-90, 226-237): compare the mean bottom-chain
energy over the 2nd quarter of the post-burn trace with the 4th quarter;
accept when |Q2 - Q4| < eps.
"""

from __future__ import annotations

import numpy as np


def quarter_means(trace_cumsum: np.ndarray, burn_start: np.ndarray, length: np.ndarray):
    """Q2/Q4 means of per-element post-burn traces.

    trace_cumsum: (T+1, B) cumulative sums of the full energy trace
    burn_start:   (B,) index of the first post-burn step
    length:       (B,) number of post-burn steps recorded (l = since_burn+1)
    Returns (q2, q4, valid) arrays of shape (B,).
    """
    l = np.maximum(length, 0)
    i0 = burn_start
    a2, b2 = i0 + l // 4, i0 + l // 2
    a4, b4 = i0 + (3 * l) // 4, i0 + l
    T = trace_cumsum.shape[0] - 1
    a2c, b2c = np.clip(a2, 0, T), np.clip(b2, 0, T)
    a4c, b4c = np.clip(a4, 0, T), np.clip(b4, 0, T)
    cols = np.arange(trace_cumsum.shape[1])
    n2 = np.maximum(b2c - a2c, 1)
    n4 = np.maximum(b4c - a4c, 1)
    q2 = (trace_cumsum[b2c, cols] - trace_cumsum[a2c, cols]) / n2
    q4 = (trace_cumsum[b4c, cols] - trace_cumsum[a4c, cols]) / n4
    valid = (b2c > a2c) & (b4c > a4c)
    return q2, q4, valid


def error_based_accept(trace_cumsum, burn_start, length, eps: float):
    """True where |Q2 - Q4| < eps (the reference's accept condition,
    decoders.py:100-105)."""
    q2, q4, valid = quarter_means(trace_cumsum, burn_start, length)
    return valid & (np.abs(q2 - q4) < eps)


class EnergyHistory:
    """Bounded-memory energy-trace history for the felkriteriet.

    The reference keeps the full per-step energy trace (decoders.py:39-42
    preallocates 5e7 float64s ~ 3.6 GB); the round-2 automaton kept a full
    prefix sum — O(B * total_steps / C) host RAM, ~4 GB at max_steps=1M.
    This class stores the PREFIX SUMS of the chunk-mean trace at at most
    ``max_rows`` group boundaries: when the cap is hit, every other
    boundary is dropped (the group span doubles), so memory is
    O(B * max_rows) for any run length (VERDICT r2 task 3).

    Accuracy: compression keeps a subset of the ORIGINAL prefix values —
    retained boundaries are exact float64 left-to-right accumulations, so
    quarter means over the retained edges are exact means of the underlying
    chunk trace (per-boundary chunk counts are tracked exactly in
    ``ccnt``).  Only the quarter BOUNDARIES snap to group edges once
    span > 1 — a shift of at most one group, i.e. <= 1/max_rows of the
    post-burn span (the buffer always holds > max_rows/2 groups).  Below
    the cap (span == 1) the automaton is bit-identical to the unbounded
    prefix-sum version: same accumulation order, same indices.
    """

    def __init__(self, n_cols: int, max_rows: int = 4096):
        self.max_rows = int(max_rows)
        alloc = min(self.max_rows + 2, 256)
        # cum[i] = float64 sum of all chunks through group i (cum[0] = 0);
        # ccnt[i] = number of chunks through group i
        self.cum = np.zeros((alloc, n_cols))
        self.ccnt = np.zeros(alloc, dtype=np.int64)
        self.n_rows = 0  # number of groups (valid rows: 0..n_rows)
        self.span = 1  # chunks per (full) group

    @property
    def nbytes(self) -> int:
        return self.cum.nbytes + self.ccnt.nbytes

    def _grow(self, need: int) -> None:
        """Ensure >= ``need`` rows; doubling capped near max_rows so the
        steady-state footprint stays O(B * max_rows) (the transient
        overshoot before a compress is at most one window of groups)."""
        cur = self.cum.shape[0]
        if need <= cur:
            return
        alloc = max(need, min(2 * cur, self.max_rows + 1025))
        cum = np.zeros((alloc, self.cum.shape[1]))
        cum[: self.n_rows + 1] = self.cum[: self.n_rows + 1]
        self.cum = cum
        ccnt = np.zeros(alloc, dtype=np.int64)
        ccnt[: self.n_rows + 1] = self.ccnt[: self.n_rows + 1]
        self.ccnt = ccnt

    def append(self, chunk_means: np.ndarray) -> None:
        """Append a window of per-chunk mean energies (Wc, B)."""
        i, wc = 0, chunk_means.shape[0]
        n = self.n_rows
        # top up the open tail group (only exists once span > 1)
        if n and self.ccnt[n] - self.ccnt[n - 1] < self.span:
            take = min(int(self.span - (self.ccnt[n] - self.ccnt[n - 1])), wc)
            self.cum[n] += chunk_means[:take].sum(axis=0)
            self.ccnt[n] += take
            i = take
        nfull, rem = divmod(wc - i, self.span)
        ngrp = nfull + (1 if rem else 0)
        if ngrp:
            self._grow(n + ngrp + 1)
            if self.span == 1:
                gs = chunk_means[i:]
                cnts = np.ones(ngrp, dtype=np.int64)
            else:
                gs = np.empty((ngrp, chunk_means.shape[1]))
                if nfull:
                    gs[:nfull] = (
                        chunk_means[i : i + nfull * self.span]
                        .reshape(nfull, self.span, -1)
                        .sum(axis=1)
                    )
                if rem:
                    gs[nfull] = chunk_means[i + nfull * self.span :].sum(axis=0)
                cnts = np.full(ngrp, self.span, dtype=np.int64)
                if rem:
                    cnts[-1] = rem
            self.cum[n + 1 : n + 1 + ngrp] = self.cum[n] + np.cumsum(gs, axis=0)
            self.ccnt[n + 1 : n + 1 + ngrp] = self.ccnt[n] + np.cumsum(cnts)
            self.n_rows += ngrp
        while self.n_rows > self.max_rows:
            self._compress()

    def _compress(self) -> None:
        """Drop every other group boundary (keeping the final one); the
        span doubles.  Pure index selection — retained prefix values stay
        exact, no re-summation error."""
        n = self.n_rows
        idx = np.arange(0, n + 1, 2)
        if n % 2:
            idx = np.append(idx, n)
        m = len(idx) - 1
        self.cum[: m + 1] = self.cum[idx]
        self.ccnt[: m + 1] = self.ccnt[idx]
        self.n_rows = m
        self.span *= 2

    def select_columns(self, sel: np.ndarray) -> None:
        """Keep only columns ``sel`` (batch compaction)."""
        self.cum = np.ascontiguousarray(self.cum[:, sel])

    def accept(self, burn_start, length, eps: float):
        """Vectorized felkriteriet over the stored history: True where
        |Q2 - Q4| < eps, with burn_start/length in CHUNK units."""
        n = self.n_rows
        cum, ccnt = self.cum[: n + 1], self.ccnt[: n + 1]
        total = int(ccnt[n])
        l = np.maximum(length, 0)
        i0 = burn_start
        bounds = np.stack(
            [i0 + l // 4, i0 + l // 2, i0 + (3 * l) // 4, i0 + l]
        )  # (4, B) in chunk units
        # snap each bound up to the next retained group edge
        g = np.searchsorted(ccnt, np.clip(bounds, 0, total))
        cols = np.arange(cum.shape[1])
        n2 = ccnt[g[1]] - ccnt[g[0]]
        n4 = ccnt[g[3]] - ccnt[g[2]]
        q2 = (cum[g[1], cols] - cum[g[0], cols]) / np.maximum(n2, 1)
        q4 = (cum[g[3], cols] - cum[g[2], cols]) / np.maximum(n4, 1)
        valid = (n2 > 0) & (n4 > 0)
        return valid & (np.abs(q2 - q4) < eps)

    def snapshot(self) -> dict:
        return {
            "cum": self.cum[: self.n_rows + 1].copy(),
            "ccnt": self.ccnt[: self.n_rows + 1].copy(),
            "span": np.asarray(self.span),
        }

    @classmethod
    def restore(cls, snap: dict, max_rows: int = 4096) -> "EnergyHistory":
        h = cls(snap["cum"].shape[1], max_rows=max_rows)
        n = snap["cum"].shape[0] - 1
        h._grow(n + 1)
        h.cum[: n + 1] = snap["cum"]
        h.ccnt[: n + 1] = snap["ccnt"]
        h.n_rows = n
        h.span = int(snap["span"])
        return h
