"""Median wall ms of a reply's host traceback (``AsrServer._results``'
``result/traceback`` spans: ``get_best_path_from`` over the utterance so
far), over the window."""

import statistics

from benchmark.metrics import _spans


def read(data):
    d = _spans.durations_ms(data, "result/traceback")
    return statistics.median(d) if d else None
