"""Share of the traced sub-window in which no operation ran on the
device (kernels, copies and fills from the profiler's trace)."""


def read(data):
    tr = data.get("trace")
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
