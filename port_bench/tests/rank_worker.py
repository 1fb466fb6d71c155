"""One rank of the small four-chip cell on the CPU, for the tests:
``python rank_worker.py RANK WORLD PORT FAULT``; rank 0 prints the result
as JSON.  ``FAULT`` ``no_exchange`` makes the gather hand back the rank's
own rows in every slot, as if the exchange of rows between cards were left
out (rank 0's stop flag, the last byte of each slot, still travels, so the
ranks stop together); ``jax_on_worker`` has every rank but 0 hold a module
named ``jax``, as if the port had loaded JAX in a worker process."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    rank, world, port, fault = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    import torch

    torch.set_num_threads(1)
    from mcmc_qec_tpu_torch.parallel import multihost

    from port_bench.run import run_cell
    from port_bench.tests.conftest import small_cell

    if fault == "jax_on_worker" and rank != 0:
        import types

        sys.modules.setdefault("jax", types.ModuleType("jax"))
    if fault == "no_exchange":
        orig = multihost.allgather_rows

        def gather(local):
            import numpy as np

            real = orig(local).reshape(world, -1)
            fake = np.tile(local, (world, 1))
            fake[:, -1] = real[:, -1]
            return fake.reshape(-1)

        multihost.allgather_rows = gather
    out = run_cell(small_cell("pteq_toric5.p015_b2603", ranks=world),
                   2**31 + 11, 0.5, False, device="cpu", rank=rank,
                   world=world, port=port)
    if out is not None:
        print(json.dumps(out[0], default=str))


if __name__ == "__main__":
    main()
