"""Median wall ms of a batch's copy of the search's state, logs and
snapshots to the host (``TorchBeamSearch.traceback``'s
``traceback/copy`` spans), over the window."""

import statistics

from benchmark.metrics import _spans


def read(data):
    d = _spans.durations_ms(data, "traceback/copy")
    return statistics.median(d) if d else None
