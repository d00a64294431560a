"""What the ``tools/perf`` microbenches share: the device line, chained-call
timing, a kernel timed in alternating pairs with its library call, the
search's host sync, and the row-gather callables of the three TPU
microbench kernels."""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from asr_decoder_tpu_torch.ops.fetch import row_gather


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; fails without a card) or "
                             "cpu (a smoke run timed by the host clock)")


def open_device(name: str) -> torch.device:
    """The device to measure on; a missing card is an error, never a quiet
    move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu for a smoke run")
    return dev


def device_line(dev: torch.device) -> str:
    """What the numbers were taken on: the card's name and power limit from
    ``nvidia-smi``, or the CPU."""
    if dev.type != "cuda":
        return "device: cpu (times are host-clock, not device times)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return (f"device: {torch.cuda.get_device_name(dev)} (nvidia-smi: "
            f"{smi.strip().splitlines()[dev.index or 0]}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")


def time_loop(loop, dev: torch.device, calls: int, replays: int = 1
              ) -> tuple[float, float | None]:
    """ms per call of ``loop()``, which makes ``calls`` calls.

    On a card: eager = ``replays`` runs timed with CUDA events (the host
    launches every kernel); graph = ``replays`` replays of one run captured
    as a CUDA graph (device time without the host's launch cost).  On the
    CPU: eager = the host clock over one run, graph = None."""
    loop()                                      # builds kernels, warms up
    if dev.type != "cuda":
        t0 = time.perf_counter()
        loop()
        return (time.perf_counter() - t0) * 1e3 / calls, None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(replays):
        loop()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / (replays * calls)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        loop()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return eager, start.elapsed_time(end) / (replays * calls)


def paired_ms(kernel, library, pairs: int, timer) -> dict:
    """``pairs`` alternating timings of ``kernel`` and ``library`` by
    ``timer(fn) -> ms``, the kernel first in even pairs and the library
    first in odd ones, so that both see the same card state.  Returns each
    side's times (``kernel``, ``library``), medians (``kernel_ms``,
    ``library_ms``) and the pairs the kernel is faster in (``wins``)."""
    ks, ls = [], []
    order = ((kernel, ks), (library, ls))
    for i in range(pairs):
        for fn, out in order if i % 2 == 0 else order[::-1]:
            out.append(timer(fn))
    return dict(kernel=ks, library=ls, kernel_ms=float(np.median(ks)),
                library_ms=float(np.median(ls)),
                wins=sum(k < lib for k, lib in zip(ks, ls)))


def paired_line(name: str, p: dict) -> str:
    """One line of a ``paired_ms`` result: each side's median and range,
    and the pairs the kernel wins."""
    ks, ls = p["kernel"], p["library"]
    return (f"{name} paired with its library call, {len(ks)} alternating "
            f"pairs: kernel {p['kernel_ms']:.4f} ms [{min(ks):.4f}, "
            f"{max(ks):.4f}], library {p['library_ms']:.4f} ms "
            f"[{min(ls):.4f}, {max(ls):.4f}]; the kernel faster in "
            f"{p['wins']} of {len(ks)}")


def force(state) -> float:
    """Wait for a search: read its live tokens' costs on the host."""
    c = state.tok_cost
    return float(torch.where(torch.isfinite(c), c, 0.0).sum())


def gather_fn(width: int | None = None, count: int | None = None):
    """``(table, idx) -> out`` through the row-gather kernel
    (``ops/fetch.py:row_gather``): rows ``i < count`` (all of ``idx`` if
    None) of a table ``width`` lanes wide.  The count is a one-element
    tensor on the table's device, made once per device — the counterpart
    of the TPU kernels' scalar-prefetch count."""
    counts: dict = {}

    def run(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if width is not None and table.shape[1] != width:
            raise ValueError(f"table is {table.shape[1]} lanes wide, this "
                             f"gather takes {width}")
        n = idx.shape[0] if count is None else count
        key = (table.device, n)
        if key not in counts:
            counts[key] = torch.tensor([n], dtype=torch.int32,
                                       device=table.device)
        return row_gather(table, idx, counts[key])
    return run
