"""stream.sample_ms_per_window: the stream scan's chunk sampler (K1's
recording launch) in device ms a stream window, from
``decoders/streaming.py::stream_timing``'s CUDA events, on in traced runs
only."""


def read(rec):
    ms, n = rec.get("stream_ms") or {}, rec.get("stream_windows")
    if "sample" not in ms or not n:
        return None
    return ms["sample"] / n
