"""Command-line interface: ``python -m mcmc_qec_tpu_torch <command>``.

The port's counterpart of ``mcmc_qec_tpu/cli.py``: the same subcommands
(generate, concat, evaluate, replay-golden, plot) and flags, plus
``--device`` (``cuda``, the default, or ``cpu``).  It replaces the
reference's SLURM-env __main__ scripts (generate_data.py:272-310,
generate_data_noise_models.py:198-237) and the concat CLI
(concat_data.py:78-99) with explicit subcommands.  Grid sweeps map a task
index to a (p_error, size) cell exactly like the reference's array jobs —
set ``--task-id`` from ``$SLURM_ARRAY_TASK_ID`` (or any scheduler's index)
for drop-in batch use.  ``generate --distributed`` is one invocation per
rank (``parallel/multihost.py``): ``--coordinator host:port`` of rank 0,
``--num-processes`` and ``--process-id`` (or a launcher's environment),
one card per rank, or the CPU with ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_config_args(p: argparse.ArgumentParser) -> None:
    from .pipeline.config import RunConfig
    import dataclasses

    for f in dataclasses.fields(RunConfig):
        arg = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=f.default)
        elif f.default is None or f.default is dataclasses.MISSING:
            p.add_argument(arg, default=f.default)
        else:
            p.add_argument(arg, type=type(f.default), default=f.default)


def _config_from_args(args) -> "RunConfig":
    from .pipeline.config import RunConfig
    import dataclasses

    kw = {}
    for f in dataclasses.fields(RunConfig):
        v = getattr(args, f.name)
        if v is not None and f.name in ("p_sampling", "Nc", "steps", "fixed_errors"):
            v = None if v in ("", "none", "None") else (
                int(v) if f.name in ("Nc", "steps", "fixed_errors") else float(v)
            )
        kw[f.name] = v
    return RunConfig(**kw)


def _run_device(args) -> str:
    """``--device``, or the CPU under ``--platform cpu`` (which pins the
    run's platform, as it pins JAX's); a ``--device`` that conflicts with
    the platform raises."""
    import torch

    from .parallel.multihost import PLATFORMS

    device = args.device
    if args.platform is None:
        return device or "cuda"
    if args.platform not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform}: expected one of "
                         f"{', '.join(PLATFORMS)}")
    kind = "cpu" if args.platform == "cpu" else "cuda"
    if device is not None and torch.device(device).type != kind:
        raise SystemExit(f"--platform {args.platform} conflicts with "
                         f"--device {device}")
    return device or kind


def cmd_generate(args) -> int:
    import torch

    args.device = _run_device(args)
    if args.distributed:
        if args.append:
            raise SystemExit("--append is not supported with --distributed")
        # join the group before any CUDA work: the rank's card becomes the
        # current device first; a CPU run takes no card
        from .parallel import init_distributed

        cpu = torch.device(args.device).type == "cpu"
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         platform="cpu" if cpu else args.platform)
    from .pipeline import generate

    cfg = _config_from_args(args)
    if args.task_id is not None:
        # reference grid convention: p from a linspace indexed by task id
        # (generate_data.py:282)
        grid = np.linspace(args.p_min, args.p_max, args.p_points)
        cfg.p_error = float(grid[args.task_id % args.p_points])
        if args.sizes:
            sizes = [int(s) for s in args.sizes.split(",")]
            cfg.size = sizes[(args.task_id // args.p_points) % len(sizes)]
            if args.steps is None:
                # re-derive the default budget for the grid's size
                # (generate_data.py:295 recomputes steps per size)
                cfg.steps = int(5 * cfg.size**5)
    if args.distributed:
        # one invocation per rank: the in-band replacement for the
        # reference's SLURM array + offline pickle merge
        # (generate_data.py:274-308, concat_data.py)
        import torch.distributed as dist

        from .parallel import distributed_generate

        ds = distributed_generate(args.out, cfg, args.n, progress=None)
        if dist.get_rank() == 0:
            print(f"wrote {len(ds)} points to {args.out}")
        dist.destroy_process_group()
        return 0
    ds = generate(args.out, cfg, nbr_datapoints=args.n, append=args.append)
    print(f"wrote {len(ds)} points to {args.out}")
    return 0


def cmd_concat(args) -> int:
    from .pipeline import Dataset, concat_datasets

    ds = concat_datasets([Dataset.load(p) for p in args.inputs])
    ds.save(args.out)
    print(f"wrote {len(ds)} points to {args.out}")
    return 0


def cmd_evaluate(args) -> int:
    from .pipeline import Dataset, evaluate_dataset

    for path in args.inputs:
        ds = Dataset.load(path)
        res = evaluate_dataset(ds)
        print(f"{path}: {res}")
    return 0


def cmd_replay_golden(args) -> int:
    from .decoders import STDC
    from .pipeline import replay_golden

    def decoder(spec, states):
        return STDC(spec, states, args.p_error, args.p_sampling,
                    droplets=args.droplets, steps=args.steps,
                    device=args.device)

    res = replay_golden(args.corpus, decoder, limit=args.limit, batch=args.batch)
    print(res)
    return 0


def cmd_plot(args) -> int:
    from .pipeline import Dataset
    from .pipeline.plot import plot_success_rates

    from .pipeline import evaluate_dataset

    curves = {}
    for path in args.inputs:
        ds = Dataset.load(path)
        label = f"{ds.config.method} d={ds.config.size}"
        curves.setdefault(label, {})[ds.config.p_error] = (
            evaluate_dataset(ds).success_rate
        )
    plot_success_rates(curves, args.out)
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mcmc_qec_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate + decode syndromes")
    _add_config_args(g)
    g.add_argument("--out", required=True)
    g.add_argument("-n", type=int, default=100, help="datapoints")
    g.add_argument("--task-id", type=int, default=None,
                   help="grid task index (e.g. $SLURM_ARRAY_TASK_ID)")
    g.add_argument("--append", action="store_true",
                   help="extend an existing dataset at --out up to -n total "
                        "points (the noise-models script's capacity-capped "
                        "resume, generate_data_noise_models.py:27-46)")
    g.add_argument("--p-min", type=float, default=0.01)
    g.add_argument("--p-max", type=float, default=0.4)
    g.add_argument("--p-points", type=int, default=10)
    g.add_argument("--sizes", type=str, default="",
                   help="comma-separated lattice sizes for the grid")
    g.add_argument("--distributed", action="store_true",
                   help="multi-process run, one rank per card: every rank "
                        "decodes its shard of -n and rank 0 writes the "
                        "gathered dataset")
    g.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (with --distributed)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    g.add_argument("--platform", default=None,
                   help="the run's platform: cpu, or cuda (gpu); a "
                        "conflicting --device raises")
    # None: --device was not given (cuda unless --platform says otherwise)
    g.set_defaults(fn=cmd_generate, device=None)

    c = sub.add_parser("concat", help="merge datasets (concat_data.py)")
    c.add_argument("inputs", nargs="+")
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_concat)

    e = sub.add_parser("evaluate", help="success/failure rates")
    e.add_argument("inputs", nargs="+")
    e.set_defaults(fn=cmd_evaluate)

    r = sub.add_parser("replay-golden", help="decode the golden failure corpus")
    r.add_argument("--corpus", required=True,
                   help="the reference's data/drl_failures_p_0.15.xz")
    r.add_argument("--p-error", type=float, default=0.15)
    r.add_argument("--p-sampling", type=float, default=0.30)
    r.add_argument("--droplets", type=int, default=4)
    r.add_argument("--steps", type=int, default=20000)
    r.add_argument("--limit", type=int, default=None)
    r.add_argument("--batch", type=int, default=64)
    r.add_argument("--device", default="cuda")
    r.set_defaults(fn=cmd_replay_golden)

    pl = sub.add_parser("plot", help="success-rate curves from datasets")
    pl.add_argument("inputs", nargs="+")
    pl.add_argument("--out", required=True)
    pl.set_defaults(fn=cmd_plot)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
