"""Median wall ms an arena tick waits for the previous tick's logs to
reach the host (``BatchedStreamingDecoder.step``'s ``tick/wait`` spans),
over the window."""

import statistics

from benchmark.metrics import _spans


def read(data):
    d = _spans.durations_ms(data, "tick/wait")
    return statistics.median(d) if d else None
