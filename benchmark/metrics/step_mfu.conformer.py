"""The whole batch's share of the card's peak, for the full-context AM's
cell: over the window's batches, the least time each batch's work needs
on the card (the larger of the AM's FLOPs at the float32 peak, counted as
``am_mfu`` counts them, and the batch's bytes as ``step_mfu.py`` counts
them, ``benchmark/conformer.py:step_bytes``) over the batch's wall time,
from its input to its words.  Nothing where the program has no
counters."""

from benchmark import conformer


def read(data):
    peaks = data.get("peaks")
    if not peaks:
        return None
    am = data["config"]["am"]
    t0, t1 = data["window"]
    least = wall = 0.0
    for (a, b, _, _, _, live), (_, _, c) in zip(data.get("steps", ()),
                                                data.get("am_steps", ())):
        if a < t0 or b > t1:
            continue
        if c is None:
            return None
        nbytes = conformer.step_bytes(am, c[0], data["K"], data["stages"],
                                      live, data["lanes"])
        least += max(conformer.am_flops(am, c[1], c[2]) / peaks["fp32_flops"],
                     nbytes / peaks["hbm_bytes_per_s"])
        wall += b - a
    return 100.0 * least / wall if wall > 0 else None
