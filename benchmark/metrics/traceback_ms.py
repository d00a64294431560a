"""Median wall ms of one batch's host traceback (``TorchBeamSearch.
traceback``), over the window."""

import statistics


def read(data):
    t0, t1 = data["window"]
    d = [b - a for a, b in data["spans"].within("traceback", t0, t1)]
    return statistics.median(d) * 1e3 if d else None
