"""Median wall ms of one reply's build (``AsrServer._results``: traceback
and word alignment over the utterance so far), over the window."""

import statistics


def read(data):
    t0, t1 = data["window"]
    d = [b - a for a, b in data["spans"].within("result", t0, t1)]
    return statistics.median(d) * 1e3 if d else None
