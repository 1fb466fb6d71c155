"""stream.merge_ms_per_window: the streamed reduction's merge (rank,
sentinel, sort-merge, occupancy) in device ms a stream window, from
``decoders/streaming.py::stream_timing``'s CUDA events, on in traced runs
only."""


def read(rec):
    ms, n = rec.get("stream_ms") or {}, rec.get("stream_windows")
    if "merge" not in ms or not n:
        return None
    return ms["merge"] / n
