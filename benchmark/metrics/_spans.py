"""The program's own spans (``asr_decoder_tpu_torch.utils.profiling``) for
the readers of per-layer metrics.  ``window(t0, t1)`` gives the spans that
lie inside ``[t0, t1]``, or None where the program records none (a version
without the recorder), where its ring overwrote a span that ended at or
after ``t0``, or where it holds none there."""

# seconds a span that a reader counts may start before the interval it
# reads (a request, or a device call that straddles a traced sub-window)
LEAD = 10.0


def window(t0, t1):
    try:
        from asr_decoder_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    lost = getattr(profiling, "lost", None)
    if spans is None or lost is None or lost(t0):
        return None
    return spans(t0, t1) or None


def durations_ms(data, name):
    """Wall ms of each ``name`` span inside the run's window, or None."""
    got = window(*data["window"])
    if got is None:
        return None
    return [(s.end - s.start) * 1e3 for s in got if s.name == name] or None


def overlap(intervals, a, b):
    """Seconds of ``[a, b]`` that the (start, end) intervals cover."""
    total, end = 0.0, a
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total
