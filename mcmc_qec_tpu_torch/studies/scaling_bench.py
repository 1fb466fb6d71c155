"""Chain-scaling efficiency across the devices (weak scaling).

North-star target: >= 80% efficiency scaling the syndrome batch over
devices.  STDC (toric d=5, 16 syndromes a device, 2 droplets of 200 steps,
the ``sweep`` engine) over 1, 2, 4 and 8 devices, as many as there are,
through ``parallel.map_shards``: shard i on device i under seed 1 + i, one
host thread a device.  The best syndromes/s of three runs after a warm-up,
and its ratio to ``devices`` times the one-device rate.

The port's copy of ``examples/scaling_bench.py``, plus ``--device``.  On the
CPU (``--cpu``, the script's virtual 8-device mesh, or ``--device cpu``)
the mesh has 8 entries of the CPU, which share its cores: the figure then
only shows that the sharded program runs.

Run:  python -m mcmc_qec_tpu_torch.studies.scaling_bench          # the cards
      python -m mcmc_qec_tpu_torch.studies.scaling_bench --cpu    # 8 CPU entries
"""

from __future__ import annotations

import argparse
import time

import torch

from ..decoders.stdc import _class_seeds, _get_stdc_fn
from ..mcmc.ladder import betas_depolarizing
from ..models import get_spec
from ..models.noise import sample_depolarizing
from ..ops.engines import resolve_device
from ..parallel import make_mesh, map_shards, replicate, shard_batch

CPU_MESH = 8
PER_DEVICE = 16  # syndromes a device
STEPS, DROPLETS = 200, 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the virtual 8-device CPU mesh (= --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)

    spec = get_spec("toric", 5)
    n_devices = CPU_MESH if device.type == "cpu" else torch.cuda.device_count()
    fn = _get_stdc_fn(spec, DROPLETS, STEPS, True, False, 0.0, "sweep")
    results = {}
    for nd in [d for d in (1, 2, 4, 8) if d <= n_devices]:
        mesh = make_mesh(nd, device=device.type)
        B = PER_DEVICE * nd
        gen = torch.Generator(device=device).manual_seed(0)
        states = sample_depolarizing(gen, spec, 0.1, (B,))
        seeds = shard_batch(_class_seeds(spec, states), mesh)
        betas = (replicate(torch.as_tensor(betas_depolarizing(0.25),
                                           dtype=torch.float32), mesh),
                 replicate(torch.as_tensor(betas_depolarizing(0.1),
                                           dtype=torch.float32), mesh))

        def run():
            out = map_shards(fn, seeds, 1, *betas)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return out

        run()
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = max(best, B / (time.perf_counter() - t0))
        results[nd] = best
        eff = best / (nd * results.get(1, best))
        print(
            f"devices={nd}: {best:8.1f} syndromes/s  "
            f"(weak-scaling efficiency {100*eff:.0f}%)",
            flush=True,
        )
    return results


if __name__ == "__main__":
    main()
