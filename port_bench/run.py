"""Run one cell of the port's benchmark once, on the card(s) of this host.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the CUDA context, loading or building the cell's kernel
library into ``mcmc_qec_tpu_torch/build/``, the input pool, one warm decode
at the cell's shape) is ``setup_s``.  Then requests are decoded back to
back for ``--seconds`` (the closed loop of ``harness.Window``); with
``--trace 1`` under ``torch.profiler``, and the per-layer metrics are
printed in place of the end-to-end ones.  Once the window has closed the
peak memory is read, the outputs of the timed path are held up against the
plain reference, and the last line of standard output is the result.

Exits non-zero, with no result, without as many CUDA cards as the cell asks
for, or when the process holds JAX or the JAX package after the window.
A cell of several ranks starts one process a rank (this file again, with
``--rank``); rank 0 prints the result.  ``--control bf16`` puts the plain
reference in bfloat16 in the kernel's place (the control of the comparison;
PTEQ's in the first window of each request, STDC's in every stream window;
the benchmark's own runs never use it).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# kernel and compiler caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
# one host thread for the libraries' own pools: the closed loop is one
# Python thread, and a pool spread over a shared host's cores only adds
# to the spread of the host-bound rates
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

NO_RESULT = 3


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> dict:
    """Name and power limit of card 0, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.rsplit(",", 1))
        return dict(card=name, power_limit=limit)
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rank: int = 0, world: int = 1,
             port=None, control=None, t0: float = T0):
    """Run the cell on this rank; rank 0 returns (result, quality), the
    others None."""
    import torch

    from port_bench import harness
    from port_bench.drivers import Context
    from port_bench.drivers import ranks as ranks_mod

    torch.set_num_threads(1)
    ctx = Context(cell, seed, device, rank, world, trace, control)
    if world > 1:
        ranks_mod.Driver.join(ctx, port)
    drv = harness.driver_class(ctx.config["driver"])(ctx)
    if world > 1:
        drv = ranks_mod.Driver(ctx, drv)
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    drv.warm()
    sync()
    setup_s = time.perf_counter() - t0
    win = harness.Window(seconds)
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    win.run(drv.decode)
    sync()
    if prof is not None:
        prof.stop()
    drv.end_window()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = drv.layer_record()
    rec.update(window_s=win.seconds_run, batch_s=win.batch_seconds)
    tr = harness.reduce_trace(prof) if prof is not None else None
    if tr is not None:
        rec.update(tr)
        from port_bench.roofline.peaks import card_rates

        rec["n_sm"], rec["clock_hz"] = card_rates(torch.cuda.current_device())
    busy = ctx.gather(tr["busy_s"] if tr else None)
    peaks = ctx.gather(peak)
    t_check = time.perf_counter()
    checks = drv.check()
    print(f"rank {rank}: the comparison took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    quality = drv.quality()
    # what every rank's process holds once the window and the comparison
    # are over: a worker's modules count as much as rank 0's
    foreign = sorted({m for ms in ctx.gather(harness.foreign_modules())
                      for m in ms})
    if rank != 0:
        return None
    requests = len(win.spans)
    attempted = requests * drv.batch * world
    bs = sorted(win.batch_seconds)
    print(f"requests {requests}: seconds min {bs[0]:.4f} median "
          f"{bs[len(bs) // 2]:.4f} max {bs[-1]:.4f}", file=sys.stderr)
    if trace:
        rec["busy_s"] = (sum(busy) / len(busy)) if tr else None
        metrics = {}
        for m in cell["per_layer"]:
            v = harness.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # the configuration names the metric its rate is reported under
        values = {"setup_s": setup_s,
                  ctx.config["rate_metric"]: attempted / win.seconds_run,
                  "batch_s_p90": harness.p90(win.batch_seconds)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=world, memory_peak_bytes=int(max(peaks)))
    breakdown = None
    if tr is not None:
        dev.update(busy_s=rec["busy_s"], window_s=win.seconds_run)
        breakdown = dict(device_ops=tr["device_ops"],
                         idle_gaps=tr["idle_gaps"])
    correct = all(v <= lim for v, lim in checks.values())
    quality.update(requests=requests, setup_s=setup_s, **(
        _card() if cuda else {}))
    return dict(correct=correct, attempted=attempted, failed=0,
                metrics=metrics, device=dev, checks=checks,
                breakdown=breakdown, foreign=foreign), quality


def main(argv=None) -> int:
    args = _args(argv)
    from port_bench import harness

    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on the card",
              file=sys.stderr)
        return NO_RESULT
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return NO_RESULT
    world = int(cell["traffic_data"].get("ranks", 1))
    rank = args.rank or 0
    port = args.port
    workers = []
    if world > 1 and args.rank is None:
        port = _free_port()
        base = [sys.executable, str(Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--port", str(port)]
        if args.control:
            base += ["--control", args.control]
        workers = [subprocess.Popen(base + ["--rank", str(r)])
                   for r in range(1, world)]
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       rank=rank, world=world, port=port,
                       control=args.control)
    finally:
        failed = []
        for w in workers:
            try:
                rc = w.wait(timeout=300)
            except subprocess.TimeoutExpired:
                w.kill()
                rc = w.wait()
            if rc != 0:
                failed.append(rc)
    found = harness.foreign_modules()
    if out is None:
        # a worker: rank 0 refuses the run when this exit code is not 0
        if found:
            print(f"rank {rank} holds {found}: the port must not load JAX "
                  f"or the JAX package", file=sys.stderr)
            return NO_RESULT
        return 0
    if failed:
        print(f"rank processes exited with {failed}", file=sys.stderr)
        return NO_RESULT
    found = sorted(set(found) | set(out[0]["foreign"]))
    if found:
        print(f"the measured process holds {found}: the port must not load "
              f"JAX or the JAX package", file=sys.stderr)
        return NO_RESULT
    result, quality = out
    print("quality " + json.dumps(quality), flush=True)
    harness.emit(result["correct"], result["attempted"], result["failed"],
                 result["metrics"], result["device"],
                 {k: tuple(v) for k, v in result["checks"].items()},
                 result["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
