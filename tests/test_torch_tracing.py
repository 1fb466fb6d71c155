"""The port's span and counter recorder (``utils/profiling.py``): off
without a profiler, nested spans with self time, parent and call id under
``torch.profiler``, threads, and the spans and counters that PTEQ's window
loop, the stream scan, the pipeline's stages and the rank gathers record
(with ``KernelCounter.rows``)."""

import importlib
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig, STDC
from mcmc_qec_tpu_torch.decoders import pteq as pteq_mod
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.ops.ladder_window import (KernelCounter,
                                                  ladder_window_counts)
from mcmc_qec_tpu_torch.ops.sweep import make_sweep, sweep_counts
from mcmc_qec_tpu_torch.parallel import multihost
from mcmc_qec_tpu_torch.utils import profiling

# the module (the package's ``generate`` attribute is the function)
generate_mod = importlib.import_module("mcmc_qec_tpu_torch.pipeline.generate")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _host_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _states(spec, B, p=0.1, seed=0):
    rng = np.random.default_rng(seed)
    s = np.where(rng.random((B, spec.nq)) < p,
                 rng.integers(1, 4, (B, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def test_off_without_a_profiler_records_nothing(monkeypatch):
    def entered(*a, **k):
        raise AssertionError("a trace range was opened with no profiler")

    monkeypatch.setattr(profiling, "_trace_range", entered)
    assert not torch.autograd._profiler_enabled()
    call = profiling.new_call()
    for _ in range(3):
        with profiling.span("a", call):
            with profiling.span("b"):
                profiling.count("n", 5)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_off_span_is_one_shared_null_context():
    assert profiling.span("a") is profiling.span("b")


def test_nested_spans_under_the_profiler(tmp_path):
    call = profiling.new_call()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with profiling.span("outer", call):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.003)
        profiling.count("things", 3)
        profiling.count("things")
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert inner["total_ns"] >= 2 * 3_000_000
    assert inner["self_ns"] == inner["total_ns"]
    assert outer["total_ns"] >= inner["total_ns"] + 2_000_000
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert (outer["parents"], inner["parents"]) == ([None], ["outer"])
    # the inner spans take the decode call's id from their parent
    assert outer["calls"] == inner["calls"] == [call]
    assert snap["counters"] == {"things": 4}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") in ("outer", "inner")]
    assert sorted(e["name"] for e in events) == ["inner", "inner", "outer"]
    # host ranges (not user annotations, which the profiler would mirror
    # onto a card's timeline), each with the decode call's id
    assert {e["cat"] for e in events} == {"cpu_op"}
    assert all(e["args"]["Concrete Inputs"] == [str(call)] for e in events)


def test_spans_from_several_threads_all_arrive():
    n_threads, n_spans = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _host_profile():
            def work(i):
                for _ in range(n_spans):
                    with profiling.span(f"outer{i % 2}", i + 1000):
                        with profiling.span("inner"):
                            profiling.count("hits")

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = profiling.snapshot()
    inner = snap["spans"]["inner"]
    assert inner["count"] == n_threads * n_spans
    # each thread nests its own spans
    assert inner["parents"] == ["outer0", "outer1"]
    assert inner["calls"] == [i + 1000 for i in range(n_threads)]
    assert sum(snap["spans"][f"outer{k}"]["count"] for k in (0, 1)) \
        == n_threads * n_spans
    assert snap["counters"]["hits"] == n_threads * n_spans


def test_kernel_counter_rows():
    c = KernelCounter()
    c.add_launch(7)
    c.add_plain(5)
    c.add_launch()
    assert (c.launches, c.plain_calls, c.rows) == (2, 1, 12)
    c.reset()
    assert (c.launches, c.plain_calls, c.rows) == (0, 0, 0)
    spec = get_spec("toric", 3)
    sweep_counts.reset()
    make_sweep(spec, 1)(torch.as_tensor(_states(spec, 5)), 3,
                        torch.ones(3))
    assert (sweep_counts.plain_calls, sweep_counts.rows) == (1, 5)


def test_pteq_window_loop_spans(monkeypatch):
    """A d=3 PTEQ decode on the CPU under the profiler: one dispatch,
    fetch and automaton span a window, ``pteq.windows`` the plain window
    calls, ``KernelCounter.rows`` the rows of every window summed (the
    batch shrinks when compaction repacks it)."""
    spec = get_spec("toric", 3)
    B = 9  # 8 rows hold the batch once one syndrome converged
    rows_seen = []
    fetch0 = pteq_mod._fetch

    def fetch(out):  # looked up at call time, so the swap sees every window
        rows_seen.append(int(out[0].state.shape[0]))
        return fetch0(out)

    monkeypatch.setattr(pteq_mod, "_fetch", fetch)
    cfg = PTEQConfig(Nc=3, max_steps=720, window=60, energy_chunk=12,
                     iters=1, TOPS=3, SEQ=1, eps=0.5, min_compact=2,
                     compact_frac=1.0)
    ladder_window_counts.reset()
    with _host_profile():
        res = PTEQ(spec, _states(spec, B, 0.05, seed=3), 0.05, cfg, seed=5,
                   device="cpu")
    snap = profiling.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    n = ladder_window_counts.plain_calls
    assert n == len(rows_seen) > 1
    assert counters == {"pteq.decodes": 1, "pteq.windows": n}
    for name in ("pteq.seed", "pteq.dispatch", "pteq.fetch",
                 "pteq.automaton"):
        assert spans[name]["count"] == n, name
        assert spans[name]["parents"] == [None]
    assert spans["pteq.compact"]["count"] in (n - 1, n)
    assert spans["pteq.start"]["count"] == spans["pteq.readout"]["count"] == 1
    assert "pteq.checkpoint" not in spans
    calls = {tuple(s["calls"]) for s in spans.values()}
    assert len(calls) == 1 and len(calls.pop()) == 1
    assert ladder_window_counts.rows == sum(rows_seen)
    assert res.buckets and min(rows_seen) < B


def test_pteq_checkpoint_span(tmp_path):
    spec = get_spec("toric", 3)
    cfg = PTEQConfig(Nc=3, max_steps=240, window=60, energy_chunk=12,
                     iters=1, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    with _host_profile():
        PTEQ(spec, _states(spec, 4), 0.1, cfg, seed=1, device="cpu")
    spans = profiling.snapshot()["spans"]
    # the restore looked for a snapshot once, and windows 2 and 4 saved one
    assert spans["pteq.checkpoint"]["count"] == 3


def test_streamed_stdc_records_stream_spans():
    spec = get_spec("toric", 3)
    with _host_profile():
        STDC(spec, _states(spec, 2), 0.1, 0.25, droplets=2, steps=40,
             conv_mult=2.0, stream=True, stream_capacity=128, stream_window=16,
             device="cpu")
    spans = profiling.snapshot()["spans"]
    # 40 steps in windows of 16: 3 windows
    for name in ("stream.sample", "stream.conv_mult", "stream.merge"):
        assert spans[name]["count"] == 3, name
        assert len(spans[name]["calls"]) == 1


def test_pipeline_stage_is_a_span():
    with _host_profile():
        with generate_mod._stage("decode"):
            pass
    spans = profiling.snapshot()["spans"]
    assert spans["pipeline.decode"]["count"] == 1
    assert not hasattr(generate_mod, "stage_timer")


def test_gather_in_a_world_of_one_records_nothing():
    assert not dist.is_initialized()
    with _host_profile():
        got = multihost.allgather_rows(np.arange(6))
    np.testing.assert_array_equal(got, np.arange(6))
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_gather_records_its_span_and_bytes(tmp_path):
    """The gather itself, in a gloo group of one process: one span and the
    bytes of every rank's slot."""
    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        with _host_profile():
            out = multihost._gather(np.arange(4, dtype=np.int64))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(out[0], np.arange(4))
    snap = profiling.snapshot()
    assert snap["spans"]["multihost.allgather"]["count"] == 1
    assert snap["counters"] == {"multihost.allgather_bytes": 32}
