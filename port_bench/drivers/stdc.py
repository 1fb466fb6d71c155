"""STDC through ``mcmc_qec_tpu_torch.decoders.stdc.STDC``.

A request is one batch of start states; the call returns the float32 class
percentages of each syndrome after every class's droplets ran the whole
step budget (streamed in windows, one K1 recording launch each, sort-merged
into the bounded buffer, when the materialised stream would pass 1 GiB).

Recording: the chunk sampler the streamed decode builds
(``decoders/stdc.py``'s ``make_chunk_sampler``, swapped in for this
process) notes each launch's chains and steps for K1's roofline; in a traced
run ``decoders/streaming.py::stream_timing`` times the sampling and the
merge of every stream window with CUDA events.

What decides ``correct``, once the window has closed, for a sample of
syndromes drawn from the seed in a sample of the requests, which the plain
reference (``reference/stdc.py``) decodes again from the same start states
under the same decode seed from scratch (class states, rain, every sampling
step, the keys and counts, the bounded set of distinct chains and Z):

- ``stream_samples_differing``: recorded samples (a chain's content key
  and X, Y, Z counts at a step) of those syndromes' chains, as K1's stream
  windows wrote them, that differ from the reference's;
- ``pct_gap_max``: the largest difference, in percentage points, between
  the percentages the decode returned and the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference import codes
from ..reference import stdc as rstdc
from . import Context


class Driver:
    def __init__(self, ctx: Context):
        from mcmc_qec_tpu_torch.decoders import stdc as sm
        from mcmc_qec_tpu_torch.decoders.streaming import (should_stream,
                                                           stream_timing)
        from mcmc_qec_tpu_torch.models import get_spec
        from mcmc_qec_tpu_torch.ops.sweep import sweep_counts

        self.ctx, self.sm = ctx, sm
        self.counts, self.timing = sweep_counts, stream_timing
        c, t = ctx.config, ctx.traffic
        self.code = codes.code(c["code"]["family"], c["code"]["size"])
        self.spec = get_spec(c["code"]["family"], c["code"]["size"])
        self.dec = dict(c["decoder"])
        self.p = float(t["p"])
        self.batch = int(t["batch"])
        self.n_pool = int(t["pool_batches"])
        self.errors, self.starts = inputs.draw_pool(
            self.code, self.p, self.n_pool + 1, self.batch, ctx.pool_seed(),
            ctx.device)
        chk = c["check"]
        self.checked = ctx.sampled(chk["every"], 1)
        self.rows_per_request = int(chk["rows"])
        self.limit = float(chk["pct_gap_limit"])
        d = self.dec
        # only the streamed path keeps a bounded buffer; whether the decode
        # streams is the port's own decision, asked of it for this shape
        streamed = should_stream(d["stream"], self.batch * self.code.n_classes,
                                 d["droplets"], d["steps"])
        self.capacity = d["stream_capacity"] if streamed else None
        self.results = {}
        self.picks = {}  # request -> rows checked
        self.stream = {}  # request -> [(keys, counts) of those rows]
        self.cur = None
        self.k1_shapes = []
        self.spans = []
        self.measuring = False
        self._install()

    def _install(self) -> None:
        sm, drv = self.sm, self
        make0 = sm.make_chunk_sampler

        def make_chunk_sampler(spec, R, D, betas, iters_per_step=1,
                               equal_betas=False, engine="pallas"):
            chunk = make0(spec, R, D, betas, iters_per_step, equal_betas,
                          engine)
            if drv.ctx.control == "bf16" and drv.measuring:
                chunk = drv._control_chunk(R, D, betas)

            def run(states, seeds_w):
                if drv.measuring:
                    drv.k1_shapes.append((int(states.shape[0]), len(seeds_w),
                                          iters_per_step, bool(equal_betas)))
                out = chunk(states, seeds_w)
                if drv.cur in drv.stream:
                    r = drv.stream_rows
                    drv.stream[drv.cur].append((out[1].index_select(0, r),
                                                out[2].index_select(0, r)))
                return out

            return run

        sm.make_chunk_sampler = make_chunk_sampler

    def _control_chunk(self, R: int, D: int, betas):
        """The plain reference sampler in bfloat16 in K1's place."""
        code = self.code
        beta = float(torch.as_tensor(betas).reshape(-1)[0])

        def chunk(states, seeds_w):
            N = states.shape[0]
            ids = torch.arange(N, device=states.device)
            st, keys, counts = rstdc.sample(
                code, states, ids, torch.as_tensor(seeds_w), beta,
                dtype=torch.bfloat16)
            n = len(seeds_w)
            return st, keys.view(R, D, n, 2), counts.view(R, D, n, 3)

        return chunk

    def _call(self, states, seed):
        d = self.dec
        return self.sm.STDC(self.spec, states, self.p, d["p_sampling"],
                            droplets=d["droplets"], steps=d["steps"],
                            seed=seed, stream=d["stream"],
                            stream_capacity=d["stream_capacity"],
                            device=self.ctx.device)

    def warm(self) -> None:
        """One decode at the cell's shape (builds or loads K1)."""
        self._call(self.starts[self.n_pool], self.ctx.decode_seed(-1))
        self.counts.reset()
        self.timing.reset()
        self.timing.enabled = self.ctx.trace
        self.measuring = True

    def decode(self, i: int, deadline=None):
        if i in self.checked:
            pick = np.sort(self.checked.rng.choice(
                self.batch, self.rows_per_request, replace=False))
            self.picks[i] = pick
            self.stream[i] = []
            K = self.code.n_classes
            self.stream_rows = torch.as_tensor(
                (pick[:, None] * K + np.arange(K)).reshape(-1),
                device=self.ctx.device)
        self.cur = i
        a = time.perf_counter()
        out = self._call(self.starts[i % self.n_pool], self.ctx.decode_seed(i))
        self.spans.append(time.perf_counter() - a)
        self.cur = None
        self.results[i] = out
        return None

    def rows(self, i: int) -> np.ndarray:
        return np.asarray(self.results[i])

    def end_window(self) -> None:
        self.measuring = False
        self.k1_launches = self.counts.launches
        self.k1_plain = self.counts.plain_calls
        self.stream_ms = self.timing.ms() if self.timing.enabled else {}
        self.stream_windows = self.timing.windows
        self.timing.enabled = False

    def layer_record(self) -> dict:
        return dict(code=self.code, k1_launches=self.k1_launches,
                    k1_shapes=list(self.k1_shapes), stream_ms=self.stream_ms,
                    stream_windows=self.stream_windows)

    def quality(self) -> dict:
        n = len(self.results)
        errs = np.concatenate([self.errors[i % self.n_pool].cpu().numpy()
                               for i in range(n)])
        dist = np.concatenate([self.results[i] for i in range(n)])
        return dict(failure_rate=inputs.failure_rate(self.code, errs, dist),
                    syndromes=int(len(dist)), k1_launches=self.k1_launches,
                    plain_calls=self.k1_plain)

    def check(self) -> dict:
        todo = sorted(self.picks)
        d = self.dec
        ref = rstdc.decode(
            self.code,
            [(self.starts[i % self.n_pool], torch.as_tensor(self.picks[i]),
              self.ctx.decode_seed(i)) for i in todo],
            self.p, d["p_sampling"], d["droplets"], d["steps"],
            self.capacity) if todo else []
        gap, samples = 0.0, 0
        for i, (pct, keys, counts) in zip(todo, ref):
            got = np.asarray(self.results[i])[self.picks[i]]
            gap = max(gap, float(np.abs(got - pct.cpu().numpy()).max()))
            n, K, D = keys.shape[:3]
            if not self.stream[i]:
                samples += keys[..., 0].numel()
                continue
            pk = torch.cat([w[0] for w in self.stream[i]], 2)
            pc = torch.cat([w[1] for w in self.stream[i]], 2)
            if pk.shape != (n * K, D) + keys.shape[3:]:
                samples += keys[..., 0].numel()
                continue
            diff = ((pk.reshape(keys.shape) != keys).any(-1)
                    | (pc.reshape(counts.shape) != counts).any(-1))
            samples += int(diff.sum())
        self.rows_checked = len(todo) * self.rows_per_request
        return {"stream_samples_differing": (samples, 0),
                "pct_gap_max": (gap, self.limit)}
