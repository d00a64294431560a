"""CUDA graphs captured inside the window (the program's ``capture``
spans, ``utils/cuda_graphs.py:GraphRunner._capture``, that start in it):
0 where every graph the window replays was captured in set-up."""

from benchmark.metrics import _spans


def read(data):
    t0, t1 = data["window"]
    got = _spans.window(t0, float("inf"))
    if got is None:
        return None
    return float(sum(1 for s in got if s.name == "capture" and s.start < t1))
