"""PTEQ_alpha through ``mcmc_qec_tpu_torch.decoders.pteq.PTEQ_alpha``: the
XZZX code under biased noise, decoded with its alpha equivalent.

A request is one batch of start states drawn under biased noise (p, eta)
(``inputs_biased``, at the probabilities of ``reference/alpha_noise.py``);
the decoder gets (pz_tilde, alpha) from the port's
``biased_alpha_equivalent``, as a study hands them to it, and builds its
ladder and energy weights (alpha, alpha, 1) itself: K2's general-beta
branch.  Everything else is ``drivers/pteq.py``'s, the recording and the
three checks with their limits of 0, except that the plain reference is the
XZZX code (``reference/xzzx.py``), its window the one for checks that mix
Paulis (``reference/mixed_window.py``), and its ladder and weights those
``reference/alpha_noise.py`` works out from (p, eta) on its own.
``__init__``, ``_control_window`` and ``_replay_windows`` are
``drivers/pteq.py``'s with those changes.

A fourth check, ``ladder_entries_differing`` (limit 0), holds the program to
the reference's problem: the entries of the betas and the weights that each
window of the checked and replayed requests was handed which differ from
the reference's ladder and weights (in float32, as K2 takes them).  A wrong
alpha equivalent or ladder in the program would otherwise go unseen, since
the window replay runs on the reference's ladder.

The quality line adds the share of the window's syndromes whose ladder
converged before the step cap (``converged``), the rows the window replay
compared (``rows_replayed``) and ``general_launches``: the program's
counter ``k2.betas.general`` (launches with per-Pauli betas), kept while
the recorder records, so in traced runs alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs_biased
from ..reference import alpha_noise, mixed_window, xzzx
from . import Context
from . import pteq as base


class Driver(base.Driver):
    def __init__(self, ctx: Context):
        from mcmc_qec_tpu_torch.decoders import pteq as pm
        from mcmc_qec_tpu_torch.models import get_spec
        from mcmc_qec_tpu_torch.models.noise import biased_alpha_equivalent
        from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts

        self.ctx, self.pm = ctx, pm
        self.counts = ladder_window_counts
        c, t = ctx.config, ctx.traffic
        if c["code"]["family"] != "xzzx":
            raise ValueError(f"{c['code']['family']!r}: the PTEQ_alpha "
                             f"driver decodes the XZZX code")
        self.code = xzzx.xzzx(c["code"]["size"])
        self.spec = get_spec("xzzx", c["code"]["size"])
        dec = c["decoder"]
        self.cfg = pm.PTEQConfig(**{k: dec[k] for k in base.CONFIG_FIELDS})
        self.Nc = self.cfg.Nc
        self.p, self.eta = float(t["p"]), float(t["eta"])
        self.batch = int(t["batch"])
        self.n_pool = int(t["pool_batches"])
        self.errors, self.starts = inputs_biased.draw_pool(
            self.code, alpha_noise.xyz_probs(self.p, self.eta),
            self.n_pool + 1, self.batch, ctx.pool_seed(), ctx.device)
        # what the decoder is handed, and the reference's own ladder
        self.pz_tilde, self.alpha = biased_alpha_equivalent(self.p, self.eta)
        pzt, alpha = alpha_noise.alpha_equivalent(self.p, self.eta)
        self.ladder = alpha_noise.ladder(pzt, alpha, self.Nc)
        self.weights = alpha_noise.weights(alpha)
        # the branches the decoder takes for this ladder (pteq_run)
        self.top_exact = bool(np.allclose(self.ladder[-1], 0.0, atol=1e-9))
        self.equal_betas = bool((self.ladder == self.ladder[:, :1]).all()
                                and np.allclose(self.weights, 1.0))
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
        self.general_launches = None
        self.handed = []  # (betas, weights) of each checked request's windows
        self._install()

    def _install(self) -> None:
        super()._install()
        pm, drv = self.pm, self
        get1 = pm._get_window_fn

        def get_window_fn(*a, **k):
            fn = get1(*a, **k)

            def window(ls, seed, betas, eq_count, since_burn, weights, *rest):
                if drv.cur in drv.fetches:
                    drv.handed.append((betas, weights))
                return fn(ls, seed, betas, eq_count, since_burn, weights,
                          *rest)

            window.engine = fn.engine
            return window

        pm._get_window_fn = get_window_fn

    def _call(self, states, seed):
        return self.pm.PTEQ_alpha(self.spec, states, self.pz_tilde,
                                  self.alpha, self.cfg, seed=seed,
                                  device=self.ctx.device)

    def _reference(self, ls, eq, sb, keys, rows, betas, **kw):
        c = self.cfg
        return mixed_window.window(
            self.code, ls[0], ls[1], ls[2], eq, sb, keys, rows, betas,
            self.weights, W=c.window, iters=c.iters, p_logical=c.p_logical,
            tops_burn=c.tops_burn, energy_chunk=c.energy_chunk,
            equal_betas=self.equal_betas, top_exact=self.top_exact, **kw)

    def _control_window(self, fn):
        """The plain reference window in bfloat16 in K2's place."""
        from mcmc_qec_tpu_torch.mcmc.ladder import LadderState

        def window(ls, seed, betas, eq_count, since_burn, weights, *rest):
            B = ls.state.shape[0]
            dev = ls.state.device
            o = self._reference(
                ls, eq_count, since_burn,
                torch.full((B,), int(seed), dtype=torch.int64, device=dev),
                torch.arange(B, device=dev), betas, dtype=torch.bfloat16)
            return (LadderState(o[0], o[1], o[2]), o[3], o[4], o[5], o[6],
                    o[7], o[2], o[8])

        window.engine = fn.engine
        return window

    def end_window(self) -> None:
        super().end_window()
        from mcmc_qec_tpu_torch.utils import profiling

        counters = profiling.snapshot().get("counters") or {}
        self.general_launches = counters.get("k2.betas.general")

    def quality(self) -> dict:
        q = super().quality()
        conv = [self.results[i][1] for i in sorted(self.results)]
        q.update(converged=float(np.mean(conv)) if conv else None,
                 general_launches=self.general_launches,
                 rows_replayed=getattr(self, "rows_replayed", None))
        return q

    def check(self) -> dict:
        out = super().check()
        out["ladder_entries_differing"] = (self._ladder_differing(), 0)
        return out

    def _ladder_differing(self) -> int:
        """Entries of the betas and weights handed to the recorded windows
        that are not the reference's; one if no window was recorded."""
        if not self.handed:
            return 1
        want_b = torch.as_tensor(self.ladder)
        want_w = torch.as_tensor(self.weights)
        bad = 0
        for handed in self.handed:
            for got, want in zip(handed, (want_b, want_w)):
                got = torch.as_tensor(got).cpu().float()
                bad += (int((got != want).sum()) if got.shape == want.shape
                        else want.numel())
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
        got = self._reference(
            cat[:3], cat[3], cat[4], torch.cat(keys).to(dev),
            torch.cat(rows).to(dev),
            torch.as_tensor(self.ladder, dtype=torch.float32, device=dev))
        R = cat[0].shape[0]
        diff = torch.zeros(R, dtype=torch.bool, device=dev)
        for j, (g, w) in enumerate(zip(got, want)):
            ne = g.to(w.dtype) != w
            if j == 5:
                diff |= ne.any(0)
            else:
                diff |= ne.reshape(R, -1).any(-1)
        return int(diff.sum()), R
