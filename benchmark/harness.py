"""What every cell's run shares: the manifest and the files it names,
spans around calls into the program, the device trace and its reduction,
the compared numbers, and the result line.

Files by name (a later cell adds files, never edits these):
``BENCHMARK.json`` at the checkout's root; ``configs/<config>.json``;
``workloads/<cell>.json`` (``kind``: the traffic module
``traffic/<kind>.py``, its ``params`` and the ``limits`` of the compared
numbers); ``metrics/<metric>.py``, else ``metrics/<name before the first
dot>.py``, with ``read(data) -> float | None``."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "benchmark"
PEAKS = json.loads((HERE / "peaks.json").read_text())
FORBIDDEN = ("jax", "jaxlib", "flax", "asr_decoder_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------

def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    entry: dict                  # the workload entry of BENCHMARK.json
    config: dict                 # configs/<config>.json
    workload: dict               # workloads/<cell>.json
    end_to_end: list             # entries this cell reports with --trace 0
    per_layer: list              # entries this cell reports with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, m: dict | None = None) -> Cell:
    m = m or manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry, config, workload,
                [e for e in m["end_to_end"] if _applies(e, name)],
                [p for p in m["per_layer"] if _applies(p, name)])


def metric_reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<base>.py`` (the name before
    its first dot): one reader serves ``step_mfu.flood`` and ``step_mfu.offline``."""
    base = name.split(".")[0]
    for stem in (name, base):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader metrics/{name}.py or metrics/{base}.py")


# ----------------------------------------------------------------------
# spans: host intervals around calls into the program (traced runs)
# ----------------------------------------------------------------------

class Spans:
    """(start, end) ``time.perf_counter`` intervals by name, from any
    thread, kept in memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_name: dict[str, list] = {}

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.by_name.setdefault(name, []).append((t0, t1))

    def within(self, name: str, t0: float, t1: float) -> list:
        return [(a, b) for a, b in self.by_name.get(name, ())
                if a >= t0 and b <= t1]


# ----------------------------------------------------------------------
# the device trace
# ----------------------------------------------------------------------

@dataclass
class DeviceTrace:
    """Device operations from ``torch.profiler`` over a sub-window."""
    ops: list = field(default_factory=list)   # (name, start s, dur s, grid)
    window: tuple = (0.0, 0.0)                # host perf_counter s

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which some operation ran (the union of intervals)."""
        busy, end = 0.0, -1e30
        for _, s, d, _ in sorted(self.ops, key=lambda o: o[1]):
            if s + d <= end:
                continue
            busy += s + d - max(s, end)
            end = s + d
        return busy

    def gaps(self) -> list:
        """Idle intervals (start, end) inside the window."""
        out, end = [], self.window[0]
        for _, s, d, _ in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                out.append((end, s))
            end = max(end, s + d)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return out


class Profiler:
    """Start and stop ``torch.profiler`` (CPU and CUDA activities); the
    Chrome trace is read back, its device operations placed on the host's
    ``perf_counter`` clock by a marker range, and the file deleted."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        with torch.profiler.record_function("benchmark_marker"):
            self._t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        t1 = time.perf_counter()
        self._prof.stop()
        CACHE.mkdir(parents=True, exist_ok=True)
        path = CACHE / f"trace.{os.getpid()}.json"
        try:
            self._prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)
        finally:
            path.unlink(missing_ok=True)
        events = events.get("traceEvents", events)
        mark = next(e for e in events if e.get("name") == "benchmark_marker")
        base = float(mark["ts"])
        ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in (
                    "kernel", "gpu_memcpy", "gpu_memset"):
                continue
            s = self._t0 + (float(e["ts"]) - base) * 1e-6
            grid = tuple((e.get("args") or {}).get("grid") or ())
            ops.append((e["name"], s, float(e["dur"]) * 1e-6, grid))
        self._prof = None
        return DeviceTrace(ops, (self._t0, t1))


def breakdown(trace: DeviceTrace, spans: Spans) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the benchmark span the host was in at the
    gap's middle (``host`` where none was open)."""
    by_op: dict[str, float] = {}
    for name, _, d, _ in trace.ops:
        name = name[:120]                  # C++ template names run long
        by_op[name] = by_op.get(name, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host"
        for sname, ivs in spans.by_name.items():
            if any(s <= mid <= e for s, e in ivs):
                name = sname
                break
        named.append([name, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


@dataclass
class Context:
    """One run: the cell, the command's arguments, the device, and the
    monotonic time at which the process started (``setup_s`` runs from
    it to the window's start)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    process_start: float
    spans: Spans = field(default_factory=Spans)

    @property
    def params(self) -> dict:
        return self.cell.workload["params"]

    @property
    def limits(self) -> dict:
        return self.cell.workload["limits"]


# ----------------------------------------------------------------------
# what a run hands back
# ----------------------------------------------------------------------

@dataclass
class Outcome:
    """A traffic module's result: end-to-end values by metric name, what
    was attempted and failed, the compared numbers ``{name: (value,
    limit)}``, the peak device memory, and what the per-layer readers
    read (``data``, with ``trace`` and ``spans`` in a traced run)."""
    end_to_end: dict
    attempted: int
    failed: int
    checks: dict
    memory_peak_bytes: int
    data: dict = field(default_factory=dict)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def check_lines(checks: dict) -> dict:
    """``{name: {"value", "limit"}}``: a number passes at or under its
    limit."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
