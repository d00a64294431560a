"""Median wall ms a call into the arena waits on ``AsrServer``'s device
thread, from its submit to its start (the program's ``device/queue``
spans), over the window."""

import statistics

from benchmark.metrics import _spans


def read(data):
    d = _spans.durations_ms(data, "device/queue")
    return statistics.median(d) if d else None
