"""The reader of ``card_walk_pct.flood`` on synthetic spans: the replies'
``path/card`` spans over all their ``path/card`` and ``path/host`` spans in
the window, and None where the program records neither, its ring overwrote
the window or it has no recorder."""

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
    return harness.metric_reader("card_walk_pct.flood")(
        {"window": (T0, T1)})


def reply(t, req, where):
    """A reply's build at ``t``: its traceback span and, inside it, where
    its path came from."""
    return [("result/traceback", t, t + 1 * MS, req),
            (f"path/{where}", t, t + 0.5 * MS, req)]


def test_card_paths_over_all_paths_in_the_window(monkeypatch):
    spans = (reply(101.0, ("a", 1), "card") + reply(102.0, ("b", 1), "card")
             + reply(103.0, ("c", 1), "card") + reply(104.0, ("a", 2), "host")
             + reply(139.9999, ("b", 2), "host")      # ends past T1
             + reply(99.0, ("c", 0), "host"))         # before T0
    assert read(monkeypatch, spans) == pytest.approx(75.0)
    assert read(monkeypatch, reply(101.0, ("a", 1), "card")) == 100.0
    assert read(monkeypatch, reply(101.0, ("a", 1), "host")) == 0.0


def test_none_without_path_spans(monkeypatch):
    # a program that walks every reply on the host and names no path span
    assert read(monkeypatch, [("result/traceback", 101.0, 101.001,
                               ("a", 1))]) is None
    assert read(monkeypatch, []) is None
    spans = reply(101.0, ("a", 1), "card") * 20
    assert read(monkeypatch, spans, capacity=8) is None   # overwritten
    monkeypatch.delattr(profiling, "spans")
    assert read(monkeypatch, reply(101.0, ("a", 1), "card")) is None
