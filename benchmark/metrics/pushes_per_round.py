"""Pushes ``AsrServer`` serves in one device-thread round: the program's
``device/push`` spans that carry a request's ``req`` (one a served push)
over its ``round`` spans, both in the window.  None where the program
records no rounds (each push then has device calls of its own)."""

from benchmark.metrics import _spans


def read(data):
    got = _spans.window(*data["window"])
    if got is None:
        return None
    rounds = sum(s.name == "round" for s in got)
    if not rounds:
        return None
    pushes = sum(s.name == "device/push" and s.req is not None for s in got)
    return pushes / rounds
