"""Share of the AM's output frames over the window's batches that are
padding: 1 − the rows' real output frames / the padded frames (the
program's counters ``frames_real`` and ``frames_out``,
``models/nnet.py``).  Nothing where the program has no counters."""


def read(data):
    t0, t1 = data["window"]
    got = [c for a, b, c in data.get("am_steps", ()) if a >= t0 and b <= t1]
    if not got or any(c is None for c in got):
        return None
    out = sum(c[0] for c in got)
    return 100.0 * (1.0 - sum(c[1] for c in got) / out) if out else None
