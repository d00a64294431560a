"""The full-context AM's useful work as a share of the card's float32
peak, on the host's clock: the FLOPs of the window's batches' real
(unpadded) rows (``benchmark/conformer.py:am_flops`` of the real output
frames and Σ T'² the program counted, ``models/nnet.py``'s
``frames_real`` and ``attn_pairs``; the padded frames the card also
computes are not counted) at the peak (``benchmark/peaks.json``; the
program keeps TF32 off), over the host wall time of the AM's calls, each
ended by a device synchronize (the benchmark's ``am`` spans, which hold
``GraphedAm``'s copy in and its outputs' clones as well as the replay).
Nothing where the program has no counters."""

from benchmark import conformer


def read(data):
    peaks = data.get("peaks")
    t0, t1 = data["window"]
    got = [(b - a, c) for a, b, c in data.get("am_steps", ())
           if a >= t0 and b <= t1]
    if not peaks or not got or any(c is None for _, c in got):
        return None
    am = data["config"]["am"]
    flops = sum(conformer.am_flops(am, c[1], c[2]) for _, c in got)
    wall = sum(w for w, _ in got)
    return 100.0 * flops / peaks["fp32_flops"] / wall if wall > 0 else None
