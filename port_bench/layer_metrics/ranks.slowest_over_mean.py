"""ranks.slowest_over_mean: in each request, the slowest rank's decode
span over the mean of the ranks' spans, averaged over the window's
requests (the spans gathered to rank 0)."""


def read(rec):
    spans = rec.get("rank_spans")
    if not spans or len(spans) < 2:
        return None
    n = min(len(s) for s in spans)
    if n == 0:
        return None
    ratios = []
    for i in range(n):
        xs = [s[i] for s in spans]
        ratios.append(max(xs) / (sum(xs) / len(xs)))
    return sum(ratios) / n
