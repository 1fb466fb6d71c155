"""One decoder over several ranks, one process and one card each, as
``python -m mcmc_qec_tpu_torch generate --distributed`` runs it.

The ranks join one ``torch.distributed`` group through
``mcmc_qec_tpu_torch.parallel.multihost.init_distributed`` (gloo, at
``tcp://127.0.0.1:<port>``).  In each request every rank decodes a batch of
its own under its own seed with the configuration's driver; then the rows
are gathered to every rank with ``multihost.allgather_rows``, the gather
``distributed_generate`` makes, with rank 0's stop flag carried in the same
gather, so all ranks stop after the same request.

Correctness adds ``gather_rows_differing``: rows that the gather returned,
on any rank and for any rank, and that differ from what that rank decoded
(each rank keeps a digest of its own rows and of every slot it received;
the digests of the rows are exchanged once the window has closed, over
another collective than the one under test).  Every other check is the
inner driver's, on each rank's own card, the worst over the ranks.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from . import Context


class Driver:
    def __init__(self, ctx: Context, inner):
        self.ctx, self.inner = ctx, inner
        self.batch = inner.batch
        self.spans = []  # this rank's decode seconds, per request
        self.mine = []  # digest of this rank's rows, per request
        self.seen = []  # digests of the slots the gather returned

    @staticmethod
    def join(ctx: Context, port: int) -> None:
        """Join the group before any work on the card."""
        from mcmc_qec_tpu_torch.parallel import multihost

        multihost.init_distributed(
            f"127.0.0.1:{port}", num_processes=ctx.world, process_id=ctx.rank,
            platform="cpu" if ctx.device == "cpu" else "cuda")

    def warm(self) -> None:
        import torch.distributed as dist

        self.inner.warm()
        dist.barrier()

    def decode(self, i: int, deadline: float) -> bool:
        from mcmc_qec_tpu_torch.parallel import multihost

        a = time.perf_counter()
        self.inner.decode(i)
        self.spans.append(time.perf_counter() - a)
        rows = np.ascontiguousarray(self.inner.rows(i))
        stop = self.ctx.rank == 0 and time.perf_counter() >= deadline
        mine = np.concatenate([rows.reshape(-1).view(np.uint8),
                               np.array([stop], np.uint8)])
        got = multihost.allgather_rows(mine).reshape(self.ctx.world, -1)
        self.mine.append(hashlib.sha1(mine[:-1].tobytes()).digest())
        self.seen.append([hashlib.sha1(g[:-1].tobytes()).digest()
                          for g in got])
        return bool(got[0, -1])

    def end_window(self) -> None:
        self.inner.end_window()

    def rows(self, i: int) -> np.ndarray:
        return self.inner.rows(i)

    def layer_record(self) -> dict:
        rec = dict(self.inner.layer_record())
        rec["rank_spans"] = self.ctx.gather(self.spans)
        return rec

    def quality(self) -> dict:
        qs = self.ctx.gather(self.inner.quality())
        n = sum(q["syndromes"] for q in qs)
        out = dict(qs[0])
        out["failure_rate"] = sum(q["failure_rate"] * q["syndromes"]
                                  for q in qs) / max(n, 1)
        out["syndromes"] = n
        return out

    def check(self) -> dict:
        mine = dict(self.inner.check())
        truth = self.ctx.gather(self.mine)
        bad = sum(self.batch for i, slots in enumerate(self.seen)
                  for r, dig in enumerate(slots) if truth[r][i] != dig)
        mine["gather_rows_differing"] = (bad, 0)
        allc = self.ctx.gather(mine)
        return {k: (max(c[k][0] for c in allc), mine[k][1]) for k in mine}
