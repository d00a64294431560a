"""The readers of the program's spans (``metrics/_spans.py`` and the
metrics that read it) on synthetic spans and a synthetic device trace:
each value, and None where the ring overwrote spans of the interval, holds
none there, or the program has no recorder."""

import pytest

from asr_decoder_tpu_torch.utils import profiling
from benchmark import harness
from benchmark.harness import DeviceTrace

MS = 1e-3
T0, T1 = 100.0, 140.0                     # the run's window


def ring_of(spans, capacity=64):
    ring = profiling.SpanRing(capacity)
    for name, start, end, req in spans:
        ring.add((name, 1, start, end, req, None))
    return ring


@pytest.fixture
def use(monkeypatch):
    def put(spans, capacity=64):
        ring = ring_of(spans, capacity)
        monkeypatch.setattr(profiling, "RING", ring)
        return ring
    return put


def read(name, **data):
    data.setdefault("window", (T0, T1))
    return harness.metric_reader(name)(data)


# (name, start, end, req); the first request ends in the window, the
# second inside it, the third after it
SERVED = [
    ("device/queue", 101.0, 101.0 + 1 * MS, ("c", 1)),
    ("device/push", 101.0, 101.0 + 2 * MS, ("c", 1)),
    ("device/queue", 102.0, 102.0 + 3 * MS, ("c", 1)),
    ("device/snapshot", 102.0, 102.0 + 4 * MS, ("c", 1)),
    ("device/step", 103.0, 103.0 + 20 * MS, None),
    ("request", 95.0, 104.0, ("c", 1)),
    ("device/queue", 110.0, 110.0 + 5 * MS, ("d", 1)),
    ("device/ready", 110.0, 110.0 + 2 * MS, ("d", 1)),
    ("request", 109.0, 111.0, ("d", 1)),
    ("device/push", 139.0, 139.0 + 7 * MS, ("e", 1)),
    ("request", 139.0, 141.0, ("e", 1)),
    ("tick/wait", 120.0, 120.0 + 1 * MS, None),
    ("tick/wait", 121.0, 121.0 + 3 * MS, None),
    ("result/traceback", 122.0, 122.0 + 4 * MS, ("c", 1)),
    ("traceback/copy", 123.0, 123.0 + 8 * MS, None),
    ("traceback/copy", 124.0, 124.0 + 6 * MS, None),
    ("traceback/copy", 125.0, 125.0 + 2 * MS, None),
    ("capture", 99.0, 99.5, None),
    ("capture", 105.0, 105.5, None),
    ("capture", 139.9, 140.2, None),
]


def test_medians_of_the_window(use):
    use(SERVED)
    assert read("device_queue_ms.flood") == pytest.approx(3.0)
    assert read("tick_wait_ms.flood") == pytest.approx(2.0)
    assert read("result_traceback_ms.flood") == pytest.approx(4.0)
    assert read("traceback_copy_ms.offline") == pytest.approx(6.0)


def test_push_host_ms_sums_each_request_ending_in_the_window(use):
    use(SERVED)
    # (2 + 4) ms and 2 ms over 2 requests; queue waits, the tick and the
    # request ending past the window are left out
    assert read("push_host_ms.flood") == pytest.approx(4.0)


def test_captures_count_those_starting_in_the_window(use):
    use(SERVED)
    assert read("captures.flood") == 2.0
    use([s for s in SERVED if s[0] != "capture"])
    assert read("captures.offline") == 0.0


def test_idle_shares_split_the_device_idle(use):
    # ops [10, 12] and [16, 17] of the window [10, 20]: idle [12, 16] and
    # [17, 20], 7 s; device calls cover [11, 13] (push) and [13.5, 14]
    # (snapshot) and [14, 15] (a tick)
    trace = DeviceTrace([("k", 10.0, 2.0, ()), ("k", 16.0, 1.0, ())],
                        (10.0, 20.0))
    use([("device/push", 11.0, 13.0, ("c", 1)),
         ("device/queue", 13.0, 13.5, ("c", 2)),
         ("device/snapshot", 13.5, 14.0, ("c", 2)),
         ("device/step", 14.0, 15.0, None),
         ("device/push", 2.0, 3.0, ("c", 0))])
    push = read("idle_push_pct.flood", trace=trace)
    unqueued = read("idle_unqueued_pct.flood", trace=trace)
    assert push == pytest.approx(15.0)          # [12, 13] and [13.5, 14]
    assert unqueued == pytest.approx(45.0)      # [13, 13.5], [15, 16], [17, 20]
    idle = harness.metric_reader("device_idle_pct.flood")({"trace": trace})
    assert push + unqueued <= idle == pytest.approx(70.0)


def test_none_on_an_overwritten_or_empty_interval(use, monkeypatch):
    trace = DeviceTrace([("k", 100.0, 1.0, ())], (100.0, 110.0))
    names = ["device_queue_ms.flood", "push_host_ms.flood",
             "tick_wait_ms.flood", "result_traceback_ms.flood",
             "traceback_copy_ms.offline", "captures.flood"]
    # a ring of 8 that overwrote spans ending in the window
    ring = use(SERVED, capacity=8)
    assert ring.evicted == len(SERVED) - 8 and ring.lost(T0)
    for n in names + ["idle_push_pct.flood", "idle_unqueued_pct.flood"]:
        assert read(n, trace=trace) is None, n
    use([])
    for n in names + ["idle_push_pct.flood", "idle_unqueued_pct.flood"]:
        assert read(n, trace=trace) is None, n
    # a window with spans, none of them the metric's
    use([("write", 101.0, 102.0, ("c", 1))])
    for n in names[:-1]:
        assert read(n) is None, n
    assert read("captures.flood") == 0.0
    # a program with no recorder: every reader gives None, none raises
    use(SERVED)
    monkeypatch.delattr(profiling, "spans")
    for n in names + ["idle_push_pct.flood", "idle_unqueued_pct.flood"]:
        assert read(n, trace=trace) is None, n
