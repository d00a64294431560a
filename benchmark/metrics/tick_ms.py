"""Median wall ms of one arena tick (``BatchedStreamingDecoder.step``: the
host packing, the AM chunk, the search frames, the log copy), over the
window."""

import statistics


def read(data):
    t0, t1 = data["window"]
    d = [b - a for a, b in data["spans"].within("tick", t0, t1)]
    return statistics.median(d) * 1e3 if d else None
