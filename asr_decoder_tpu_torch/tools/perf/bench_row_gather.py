"""Microbenchmark: row-gather strategies for the search's record fetch.

Port of ``tools/perf/bench_row_gather.py``.  At production shapes
([2M, 128] i32 table, 131,072 indices) it compares

  xla — the plain ``table[idx]`` (the JAX tool's XLA gather)
  dma — the hand-written row-gather kernel (``csrc/fetch.cu`` through
        ``ops/fetch.py:row_gather``), the counterpart of the Pallas per-row
        DMA pipeline ``make_dma_gather``

Marginal cost: R chained calls, each call's indices derived from the
previous call's rows (``nxt = (idx + out[:, 0] + 1) % S``), timed with CUDA
events as eager calls and as one CUDA-graph replay of the R calls.
The TPU knobs ``block_rows`` and ``nsem`` (DMAs in flight) have no CUDA
meaning, so ``make_dma_gather`` takes none.

Usage: python -m asr_decoder_tpu_torch.tools.perf.bench_row_gather
       [--device cuda|cpu] [--rows S] [--nidx N] [--repeats R]
"""

from __future__ import annotations

import argparse

import torch

from asr_decoder_tpu_torch.tools.perf._common import (device_arg,
                                                      device_line, gather_fn,
                                                      open_device, time_loop)

S = 2_000_000
W = 128          # row lanes (512 B rows)
NIDX = 131_072
R = 20           # chained calls


def xla_row_gather(table, idx):
    return table[idx]


def make_dma_gather():
    """Rows gathered by the row-gather kernel, one warp a row."""
    return gather_fn()


def chain(fn, table, idx, repeats=R):
    """``repeats`` chained calls of ``fn``, each call's indices derived from
    the rows the previous call gathered."""
    S_ = table.shape[0]

    def loop():
        carry = idx
        for _ in range(repeats):
            out = fn(table, carry)
            carry = (carry + out[:, 0] + 1) % S_
        return carry
    return loop


def bench(fn, table, idx, label, repeats=R) -> tuple[float, float | None]:
    """Time ``repeats`` chained calls of ``fn``; prints ms/call, ns/idx and
    GB/s, eager and as a CUDA-graph replay; returns (eager, graph) ms."""
    n, W_ = idx.shape[0], table.shape[1]
    eager, graph = time_loop(chain(fn, table, idx, repeats), table.device,
                             repeats)
    row = [f"{label:34s}"]
    for name, ms in (("eager", eager), ("graph", graph)):
        if ms is None:
            continue
        row.append(f"{name} {ms:9.4f} ms/call {ms * 1e6 / n:7.2f} ns/idx "
                   f"{n * W_ * 4 / ms / 1e6:8.1f} GB/s")
    print("  ".join(row), flush=True)
    return eager, graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--rows", type=int, default=S)
    ap.add_argument("--nidx", type=int, default=NIDX)
    ap.add_argument("--repeats", type=int, default=R)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    print(device_line(dev), flush=True)
    # made on the device: the 1 GB table never crosses the host link
    table = torch.randint(0, 127, (args.rows, W), dtype=torch.int32,
                          device=dev, generator=torch.Generator(dev)
                          .manual_seed(0))
    idx = torch.randint(0, args.rows, (args.nidx,), dtype=torch.int32,
                        device=dev, generator=torch.Generator(dev)
                        .manual_seed(1))
    tag = f"[{args.rows},{W}]x{args.nidx}"
    bench(xla_row_gather, table, idx, f"xla {tag}", args.repeats)
    bench(make_dma_gather(), table, idx, f"dma {tag}", args.repeats)


if __name__ == "__main__":
    main()
