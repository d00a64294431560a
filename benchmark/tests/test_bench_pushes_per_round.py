"""The reader of ``pushes_per_round.flood`` on synthetic spans: the
served pushes (``device/push`` with a ``req``) over the ``round`` spans in
the window, and None where the program records no rounds, its ring
overwrote the window or it has no recorder."""

import pytest

from asr_decoder_tpu_torch.utils import profiling
from benchmark import harness

MS = 1e-3
T0, T1 = 100.0, 140.0


def read(monkeypatch, spans, capacity=64):
    ring = profiling.SpanRing(capacity)
    for name, start, end, req in spans:
        ring.add((name, 1, start, end, req, None))
    monkeypatch.setattr(profiling, "RING", ring)
    return harness.metric_reader("pushes_per_round.flood")(
        {"window": (T0, T1)})


def one_round(t, reqs):
    """A round at ``t`` serving a push of each of ``reqs``: its shared
    fbank, each push's own part, and the round itself."""
    out = [("device/push", t, t + 1 * MS, None)]
    out += [("device/push", t + 2 * MS, t + 3 * MS, r) for r in reqs]
    return out + [("round", t, t + 10 * MS, None)]


def test_pushes_over_rounds_in_the_window(monkeypatch):
    spans = (one_round(101.0, [("a", 1), ("b", 1), ("c", 1)])
             + one_round(102.0, [("a", 2)])
             + one_round(139.999, [("b", 2), ("c", 2)])   # ends past T1
             + one_round(99.0, [("d", 1)]))               # before T0
    assert read(monkeypatch, spans) == pytest.approx(2.0)


def test_none_without_rounds(monkeypatch):
    # the per-push server: device calls of each push, no round
    assert read(monkeypatch, [("device/push", 101.0, 101.001, ("a", 1)),
                              ("device/step", 102.0, 102.02, None)]) is None
    assert read(monkeypatch, []) is None
    spans = one_round(101.0, [("a", 1)]) * 20
    assert read(monkeypatch, spans, capacity=8) is None   # overwritten
    monkeypatch.delattr(profiling, "spans")
    assert read(monkeypatch, one_round(101.0, [("a", 1)])) is None
