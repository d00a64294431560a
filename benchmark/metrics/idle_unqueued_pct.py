"""Share of the traced sub-window in which the device is idle (no kernel,
copy or fill in the profiler's trace) while ``AsrServer``'s device thread
is inside no call (no ``device/<call>`` span, ``device/step`` included):
the card waits on the event loop, the result threads or the clients."""

from benchmark.metrics import _spans


def read(data):
    tr = data.get("trace")
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    a, b = tr.window
    got = _spans.window(a - _spans.LEAD, b + _spans.LEAD)
    calls = [(s.start, s.end) for s in got or ()
             if s.name.startswith("device/") and s.name != "device/queue"
             and s.end > a and s.start < b]
    if not calls:
        return None
    idle = sum(g1 - g0 - _spans.overlap(calls, g0, g1)
               for g0, g1 in tr.gaps())
    return 100.0 * idle / tr.window_s
