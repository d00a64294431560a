"""Share of the window's batches' wall time (input to words) spent in the
AM's calls, each ended by a device synchronize (the benchmark's ``am``
spans)."""


def read(data):
    t0, t1 = data["window"]
    batches = sum(b - a for a, b, *_ in data.get("steps", ())
                  if a >= t0 and b <= t1)
    am = sum(b - a for a, b, _ in data.get("am_steps", ())
             if a >= t0 and b <= t1)
    return 100.0 * am / batches if batches > 0 else None
