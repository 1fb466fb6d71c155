"""The readers of the program's spans and counters (``layer_metrics/
_recorder.py`` and the metrics over it): the right number from a planted
snapshot and K2 counter, None from an empty one, from a record without a
trace, and from a program without the recorder."""

import pytest

from port_bench import harness

TRACED = {"kernels": {}}  # the record of a traced run holds the reduction

SNAP = {
    "spans": {
        "pteq.dispatch": dict(count=80, total_ns=160_000_000,
                              self_ns=120_000_000, parents=[None], calls=[1]),
        "pteq.automaton": dict(count=80, total_ns=100_000_000,
                               self_ns=80_000_000, parents=[None], calls=[1]),
        "pteq.compact": dict(count=78, total_ns=20_000_000,
                             self_ns=20_000_000, parents=[None], calls=[1]),
        "multihost.allgather": dict(count=4, total_ns=10_000_000,
                                    self_ns=10_000_000, parents=[None],
                                    calls=[]),
    },
    "counters": {"pteq.windows": 80, "pteq.decodes": 2},
}

WANT = {
    "pteq.dispatch_ms_per_window": 120.0 / 80,  # self ms over the count
    "pteq.automaton_ms_per_window": 80.0 / 80,
    "pteq.compact_ms_per_window": 20.0 / 80,  # total over pteq.windows
    "pteq.windows_per_batch": 40.0,
    "k2.rows_per_launch": 3000 / 12,
    "ranks.gather_ms": 2.5,
}


@pytest.fixture
def planted(monkeypatch):
    """The recorder's snapshot and K2's counter set to ``snap``, ``rows``
    over 10 launches and 2 plain calls."""
    from mcmc_qec_tpu_torch.ops import ladder_window
    from mcmc_qec_tpu_torch.ops.ladder_window import KernelCounter
    from mcmc_qec_tpu_torch.utils import profiling

    def plant(snap, rows):
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
        c = KernelCounter()
        for k in range(12):
            (c.add_launch if k < 10 else c.add_plain)(rows // 12)
        monkeypatch.setattr(ladder_window, "ladder_window_counts", c)

    return plant


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_from_a_planted_snapshot(planted, name):
    planted(SNAP, 3000)
    assert harness.reader(name)(TRACED) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_from_an_empty_snapshot(planted, name):
    planted({"spans": {}, "counters": {}}, 0)
    assert harness.reader(name)(TRACED) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_a_trace(planted, name):
    planted(SNAP, 3000)
    assert harness.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_the_recorder(monkeypatch, name):
    """The parent of the recorder: no ``profiling.snapshot``, no
    ``KernelCounter.rows``."""
    from mcmc_qec_tpu_torch.ops import ladder_window
    from mcmc_qec_tpu_torch.utils import profiling

    class OldCounter:
        launches, plain_calls = 40, 0

    monkeypatch.delattr(profiling, "snapshot")
    monkeypatch.setattr(ladder_window, "ladder_window_counts", OldCounter())
    assert harness.reader(name)(TRACED) is None


def test_stream_sample_reader():
    read = harness.reader("stream.sample_ms_per_window")
    rec = dict(stream_ms={"merge": 160.0, "sample": 320.0}, stream_windows=4)
    assert read(rec) == pytest.approx(80.0)
    assert read(dict(stream_ms={}, stream_windows=0)) is None
    assert read({}) is None


def test_every_new_metric_has_its_entry():
    names = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in [*WANT, "stream.sample_ms_per_window",
                 "ranks.slowest_over_mean"]:
        assert name in names, name
    x4 = "pteq_toric5.p015_b2603_x4"
    for name in ("ranks.gather_ms", "ranks.slowest_over_mean"):
        assert names[name]["workloads"] == [x4]
    for name in WANT:
        if name.startswith(("pteq.", "k2.")):
            assert names[name]["workloads"] == ["pteq_toric5.p015_b2603", x4]
