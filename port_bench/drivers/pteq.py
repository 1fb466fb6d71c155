"""PTEQ through ``mcmc_qec_tpu_torch.decoders.pteq.PTEQ``.

A request is one batch of start states; the call returns the uint8 class
percentages of each syndrome once its ladder converged or ran out of steps.

Recording, around the port's own functions (module attributes, swapped in
for this process): ``_get_window_fn``'s window, so each K2 launch's rows
are known and, in the requests chosen for the replay, its inputs and
outputs are kept (references to the tensors the window made, no copy); and
``_fetch``, so each window's host summaries are kept in the requests whose
readout is checked.

What decides ``correct``, once the window has closed:

- ``window_rows_differing``: rows of the replayed windows (a sample of rows
  of every window of the replay requests) where the plain reference window
  (``reference/window.py``), run on the window's own inputs, seed and batch
  position, differs from K2 in any output: ladder state, flags, tops0,
  class counts, since_burn, energies, burn flags, swap counts;
- ``chain_breaks``: in those requests, differences between what a window
  was handed and what the decode's start or the window before produced
  (through the compaction the host replay works out), between the window
  seeds and those the decode seed gives, and between the host's summaries
  and the window's outputs;
- ``readout_syndromes_differing``: syndromes of the checked requests whose
  percentages, convergence, steps or tops0 differ from the host loop
  worked out again from the windows' summaries (``reference/pteq_host.py``).

The replay follows the decode from the program's own state window by
window; the start and the seeds are checked by themselves.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference import codes, pteq_host
from ..reference import window as rwin
from . import Context

CONFIG_FIELDS = ("Nc", "SEQ", "TOPS", "tops_burn", "eps", "max_steps", "iters",
                 "p_logical", "window", "conv_criteria", "engine",
                 "energy_chunk")


class Driver:
    def __init__(self, ctx: Context):
        from mcmc_qec_tpu_torch.decoders import pteq as pm
        from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_depolarizing
        from mcmc_qec_tpu_torch.models import get_spec
        from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts

        self.ctx, self.pm = ctx, pm
        self.counts = ladder_window_counts
        c, t = ctx.config, ctx.traffic
        self.code = codes.code(c["code"]["family"], c["code"]["size"])
        self.spec = get_spec(c["code"]["family"], c["code"]["size"])
        dec = c["decoder"]
        self.cfg = pm.PTEQConfig(**{k: dec[k] for k in CONFIG_FIELDS})
        self.Nc = self.cfg.Nc
        self.p = float(t["p"])
        self.batch = int(t["batch"])
        self.n_pool = int(t["pool_batches"])
        self.errors, self.starts = inputs.draw_pool(
            self.code, self.p, self.n_pool + 1, self.batch, ctx.pool_seed(),
            ctx.device)
        self.ladder = beta_ladder_depolarizing(self.p, self.Nc)
        # the branches the decoder takes for this ladder (pteq_run)
        self.top_exact = bool(np.allclose(self.ladder[-1], 0.0, atol=1e-9))
        self.equal_betas = bool((self.ladder == self.ladder[:, :1]).all())
        chk = c["check"]
        self.checked = ctx.sampled(chk["every"], 1)
        self.replayed = ctx.sampled(chk["replay_every"], 2)
        self.replay_rows = int(chk["replay_rows"])
        self.cur = None
        self.windows = {}  # request -> [(seed, inputs, outputs)]
        self.fetches = {}  # request -> [host summaries]
        self.results = {}
        self.k2_rows = []  # rows of every window call in the measured window
        self.spans = []  # seconds of every PTEQ call in the measured window
        self.measuring = False
        self.n_windows = 0  # window calls of the current request
        self._install()

    # --- recording ---------------------------------------------------------

    def _install(self) -> None:
        pm, drv = self.pm, self
        get0, fetch0 = pm._get_window_fn, pm._fetch

        def get_window_fn(*a, **k):
            fn = get0(*a, **k)
            ctl = None
            if drv.ctx.control == "bf16" and drv.measuring:
                ctl = drv._control_window(fn)

            def window(ls, seed, betas, eq_count, since_burn, weights, *rest):
                # the control takes K2's place in each request's first
                # window, where every row of the batch is in the launch
                f = ctl if ctl is not None and drv.n_windows == 0 else fn
                drv.n_windows += 1
                out = f(ls, seed, betas, eq_count, since_burn, weights, *rest)
                drv._on_window(ls, seed, eq_count, since_burn, out)
                return out

            window.engine = fn.engine
            return window

        def fetch(out):
            f = fetch0(out)
            if drv.cur in drv.fetches:
                drv.fetches[drv.cur].append(f)
            return f

        pm._get_window_fn = get_window_fn
        pm._fetch = fetch

    def _on_window(self, ls, seed, eq, sb, out) -> None:
        if self.measuring:
            self.k2_rows.append(int(ls.state.shape[0]))
        if self.cur in self.windows:
            o = out[0]
            self.windows[self.cur].append((
                int(seed), (ls.state, ls.flag, ls.tops0, eq, sb),
                (o.state, o.flag, o.tops0, out[1], out[2], out[3], out[4],
                 out[5], out[7])))

    def _control_window(self, fn):
        """The plain reference window in bfloat16 in K2's place."""
        from mcmc_qec_tpu_torch.mcmc.ladder import LadderState

        cfg, code = self.cfg, self.code

        def window(ls, seed, betas, eq_count, since_burn, weights, *rest):
            B = ls.state.shape[0]
            dev = ls.state.device
            o = rwin.window(
                code, ls.state, ls.flag, ls.tops0, eq_count, since_burn,
                torch.full((B,), int(seed), dtype=torch.int64, device=dev),
                torch.arange(B, device=dev), betas, weights, W=cfg.window,
                iters=cfg.iters, p_logical=cfg.p_logical,
                tops_burn=cfg.tops_burn, energy_chunk=cfg.energy_chunk,
                equal_betas=self.equal_betas, top_exact=self.top_exact,
                dtype=torch.bfloat16)
            return (LadderState(o[0], o[1], o[2]), o[3], o[4], o[5], o[6],
                    o[7], o[2], o[8])

        window.engine = fn.engine
        return window

    # --- the timed path ----------------------------------------------------

    def _call(self, states, seed):
        return self.pm.PTEQ(self.spec, states, self.p, self.cfg, seed=seed,
                            device=self.ctx.device)

    def warm(self) -> None:
        """One decode at the cell's shape (builds or loads K2); then the
        allocator's small-block pool is grown by what the replay requests
        will hold, so that keeping their windows' tensors makes no
        ``cudaMalloc`` in the measured window."""
        self._call(self.starts[self.n_pool], self.ctx.decode_seed(-1))
        if self.ctx.device != "cpu":
            n = int(self.ctx.config["check"]["reserve_mb"]) * 2
            held = [torch.empty(1 << 19, dtype=torch.uint8,
                                device=self.ctx.device) for _ in range(n)]
            del held
        self.counts.reset()
        self.measuring = True

    def decode(self, i: int, deadline=None):
        self.cur, self.n_windows = i, 0
        if i in self.checked or i in self.replayed:
            self.fetches[i] = []
        if i in self.replayed:
            self.windows[i] = []
        a = time.perf_counter()
        res = self._call(self.starts[i % self.n_pool], self.ctx.decode_seed(i))
        self.spans.append(time.perf_counter() - a)
        self.results[i] = (res.distribution, res.converged, res.steps,
                           res.tops0, res.window)
        self.cur = None
        return None

    def rows(self, i: int) -> np.ndarray:
        return self.results[i][0]

    def end_window(self) -> None:
        self.measuring = False
        self.k2_launches = self.counts.launches
        self.k2_plain = self.counts.plain_calls

    # --- what the per-layer metrics read -------------------------------------

    def layer_record(self) -> dict:
        c = self.cfg
        shape = (c.Nc, c.window, c.iters, c.energy_chunk, self.equal_betas,
                 self.top_exact)
        return dict(code=self.code, pteq_call_s=sum(self.spans),
                    k2_launches=self.k2_launches,
                    k2_shapes=[(b,) + shape for b in self.k2_rows])

    def quality(self) -> dict:
        n = len(self.results)
        errs = np.concatenate([self.errors[i % self.n_pool].cpu().numpy()
                               for i in range(n)])
        dist = np.concatenate([self.results[i][0] for i in range(n)])
        return dict(failure_rate=inputs.failure_rate(self.code, errs, dist),
                    syndromes=int(len(dist)),
                    windows=self.results[0][4] if n else None,
                    k2_launches=self.k2_launches, plain_calls=self.k2_plain)

    # --- correctness -------------------------------------------------------

    def _replay_host(self, i: int):
        c = self.cfg
        return pteq_host.replay(
            self.fetches[i], self.batch, self.code.n_classes,
            n_windows=max(1, c.max_steps // c.window),
            energy_chunk=c.energy_chunk, TOPS=c.TOPS, SEQ=c.SEQ, eps=c.eps,
            compact=c.compact, compact_frac=c.compact_frac,
            min_compact=c.min_compact, max_rows=c.cum_rows_cap)

    def check(self) -> dict:
        readout, chain, host = 0, 0, {}
        for i in sorted(self.fetches):
            dist, conv, steps, tops, _ = self.results[i]
            try:
                host[i] = self._replay_host(i)
            except ValueError:
                readout += self.batch
                continue
            d, cv, st, tp = host[i][:4]
            bad = ((d != dist).any(-1) | (cv != conv) | (st != steps)
                   | (tp != tops))
            readout += int(bad.sum())
        rows_bad, rows_done = self._replay_windows()
        for i, wins in self.windows.items():
            chain += self._chain(i, wins, host.get(i))
        self.rows_replayed = rows_done
        return {"window_rows_differing": (rows_bad, 0),
                "chain_breaks": (chain, 0),
                "readout_syndromes_differing": (readout, 0)}

    def _chain(self, i: int, wins, host) -> int:
        """Mismatches between what each window of request ``i`` was handed
        and where it must come from."""
        if host is None:
            return 1
        bad = 0
        gen = torch.Generator().manual_seed(int(self.ctx.decode_seed(i)))
        st0 = self.starts[i % self.n_pool]
        B, Nc = self.batch, self.Nc
        start = (st0.unsqueeze(1).expand(B, Nc, -1),
                 torch.tensor([0] * (Nc - 1) + [1], dtype=torch.int32,
                              device=st0.device).expand(B, Nc),
                 torch.zeros(B, dtype=torch.int32, device=st0.device),
                 torch.zeros((B, self.code.n_classes), dtype=torch.int32,
                             device=st0.device),
                 torch.zeros(B, dtype=torch.int32, device=st0.device))
        row_maps = host[4]
        fetches = self.fetches[i]
        if len(wins) != len(fetches):
            return 1 + abs(len(wins) - len(fetches))
        prev = None
        for k, (seed, ins, outs) in enumerate(wins):
            want = int(torch.randint(0, 2**31 - 1, (), generator=gen))
            bad += int(seed != want)
            if k == 0:
                src = start
            else:
                sel = _selection(row_maps[k - 1], row_maps[k])
                src = tuple(t.index_select(0, torch.as_tensor(
                    sel, device=t.device)) for t in prev)
            bad += sum(int(not torch.equal(a, b)) for a, b in zip(ins, src))
            en, ba, bf, tp, sw, sb, ec = fetches[k]
            dev_out = (outs[5], outs[6], outs[7], outs[2], outs[8], outs[4],
                       outs[3])
            host_out = (en, ba, bf, tp, sw, sb, ec)
            bad += sum(int(not np.array_equal(a.cpu().numpy(), b))
                       for a, b in zip(dev_out, host_out))
            prev = outs[:5]
        return bad

    def _replay_windows(self):
        """Replay a sample of rows of every kept window in one reference
        call; returns (rows differing, rows replayed)."""
        rng = np.random.default_rng([int(self.ctx.seed), 3, self.ctx.rank])
        ins, outs, keys, rows = [], [], [], []
        for i in sorted(self.windows):
            for seed, a, b in self.windows[i]:
                Br = a[0].shape[0]
                pick = np.sort(rng.choice(Br, min(self.replay_rows, Br),
                                          replace=False))
                p = torch.as_tensor(pick, device=a[0].device)
                ins.append([t.index_select(0, p) for t in a])
                outs.append([t.index_select(-1 if j == 5 else 0, p)
                             for j, t in enumerate(b)])
                keys.append(torch.full((len(pick),), seed, dtype=torch.int64))
                rows.append(torch.as_tensor(pick, dtype=torch.int64))
        if not ins:
            return 0, 0
        cat = [torch.cat([x[j] for x in ins]) for j in range(5)]
        want = [torch.cat([x[j] for x in outs], -1 if j == 5 else 0)
                for j in range(9)]
        dev = cat[0].device
        c = self.cfg
        got = rwin.window(
            self.code, *cat, torch.cat(keys).to(dev), torch.cat(rows).to(dev),
            torch.as_tensor(self.ladder, dtype=torch.float32, device=dev),
            np.ones(3, np.float32), W=c.window, iters=c.iters,
            p_logical=c.p_logical, tops_burn=c.tops_burn,
            energy_chunk=c.energy_chunk, equal_betas=self.equal_betas,
            top_exact=self.top_exact)
        R = cat[0].shape[0]
        diff = torch.zeros(R, dtype=torch.bool, device=dev)
        for j, (g, w) in enumerate(zip(got, want)):
            ne = g.to(w.dtype) != w
            if j == 5:
                diff |= ne.any(0)
            else:
                diff |= ne.reshape(R, -1).any(-1)
        return int(diff.sum()), R


def _selection(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Positions in the batch of ``old`` (a row map) that the batch of
    ``new`` holds: each syndrome's old position, padding rows the first."""
    if len(old) == len(new) and np.array_equal(old, new):
        return np.arange(len(new))
    pos = {int(r): j for j, r in enumerate(old) if r >= 0}
    first = pos[int(new[0])]
    return np.asarray([pos[int(r)] if r >= 0 else first for r in new])
