"""The gather kernel's share of its roofline (``ops/gather.py`` +
``csrc/gather.cu``): over the traced sub-window, the least time the
launches' bytes need at the card's HBM bandwidth over the kernel's
device time.

A launch moves ``4 * B * (V*P + N + N*P)`` bytes: each of its P tables'
rows read once, the index read once, each output written once
(``csrc/gather.cu``'s own count).  Its shape comes from the shapes the
program's captures recorded (``ops/gather.py:shapes``), matched to the
trace's kernel by the table count P (the template argument), B (grid y)
and N's blocks of 1024 (grid x).  Where several recorded shapes match a
launch, the fewest bytes among them are counted, so the share is a lower
bound; where none matches, nothing is reported."""

import re

from benchmark.harness import log

P_RE = re.compile(r"gather_kernel<(\d+)")


def launch_bytes(B, V, N, P):
    return 4 * B * (V * P + N + N * P)


def read(data):
    tr, shapes, peaks = data.get("trace"), data.get("gather_shapes"), \
        data.get("peaks")
    if tr is None or not shapes or not peaks:
        return None
    least = busy = 0.0
    for name, _, dur, grid in tr.ops:
        m = P_RE.search(name)
        if not m:
            continue
        P = int(m.group(1))
        cands = [launch_bytes(B, V, N, len(dt)) for B, V, N, dt in shapes
                 if len(grid) >= 2 and len(dt) == P and B == grid[1]
                 and -(-N // 1024) == grid[0]]
        if not cands:
            log(f"gather_roofline: no recorded shape has P {P} and grid "
                f"{grid}")
            return None
        least += min(cands) / peaks["hbm_bytes_per_s"]
        busy += dur
    return 100.0 * least / busy if busy > 0 else None
