"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's inputs from the seed, sets up the program, warms every
shape the cell's traffic uses (all of it counted as ``setup_s``), drives
the traffic for ``--seconds`` and reports the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from spans, counters and a
device trace (``--trace 1``).  Once the window has closed and the peak
device memory is read, the program's state is freed and the plain
reference (``benchmark/reference``) judges what the timed path produced.
The numbers compared are printed beside their limits as the last lines of
standard error and under ``checks``, the last key of the result, which is
the last line of standard output.

Exits non-zero with no result without a CUDA device (or with fewer than
the cell asks for), and when a module named ``jax``, ``jaxlib``, ``flax``
or ``asr_decoder_tpu`` is loaded once the window has closed."""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             manifest: dict | None = None) -> dict:
    """The run as a dict in the result line's key order.  ``overrides``
    (tests only) replace keys of the configuration and of the workload's
    ``params`` and ``limits``, to run a cell at a tiny size on the CPU."""
    import torch
    from benchmark import harness
    cell = harness.cell(workload, manifest)
    for section, over in (overrides or {}).items():
        target = (cell.config if section == "config"
                  else cell.workload[section])
        target.update(over)
    # float32 products stay float32 on the card (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    kind = importlib.import_module(f"benchmark.traffic.{cell.workload['kind']}")
    ctx = harness.Context(cell, seed, seconds, trace, dev, PROCESS_START)
    out = kind.run(ctx)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(out.data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device_rec = harness.device_info(dev, cell.entry["chips"])
    device_rec["memory_peak_bytes"] = out.memory_peak_bytes
    result = {"correct": harness.correct(out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_rec}
    if trace and "trace" in out.data:
        tr = out.data["trace"]
        device_rec["busy_s"] = tr.busy_s()
        device_rec["window_s"] = tr.window_s
        result["breakdown"] = harness.breakdown(tr, out.data["spans"])
    result["checks"] = harness.check_lines(out.checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # keep any library from loading JAX behind the program's back
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch
    from benchmark import harness
    chips = harness.cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded after the window: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
