"""Device-thread ms a served push costs outside the arena's ticks: the
durations of the program's ``device/<call>`` spans other than
``device/step`` (``push``, ``ready``, ``endpoint_detected``, ``snapshot``,
``acquire``, ``release``, ``init_decoding``) that carry the ``req`` of a
``request`` span ending in the window, summed, over those requests."""

from benchmark.metrics import _spans


def read(data):
    t0, t1 = data["window"]
    got = _spans.window(t0 - _spans.LEAD, t1)
    if got is None:
        return None
    reqs = {s.req for s in got
            if s.name == "request" and t0 <= s.end <= t1}
    if not reqs:
        return None
    busy = sum(s.end - s.start for s in got
               if s.name.startswith("device/")
               and s.name not in ("device/step", "device/queue")
               and s.req in reqs)
    return busy / len(reqs) * 1e3
