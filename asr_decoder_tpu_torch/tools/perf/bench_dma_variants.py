"""Microbench: row-gather scaling (width, dynamic count) plus the search's
sort and top-k shapes at production sizes.

Port of ``tools/perf/bench_dma_variants.py``.  ``make_dma`` and
``make_dma_dyn`` are the counterparts of the TPU kernels of the same names:
the row-gather kernel (``csrc/fetch.cu`` through ``ops/fetch.py:
row_gather``) over all rows, or over the first ``nlive`` only, with the
count read by the kernel from device memory; each is also timed in
``PAIRS`` alternating pairs with ``torch.index_select`` over the same live
indices (``_common.paired_ms``).  The TPU knobs
``block_rows``, ``nsem`` and ``unroll`` drive its DMA pipeline and have no
CUDA meaning: the factories take none, and the JAX tool's unroll sweep has
no counterpart here.  The sorts go through the port's own ordering helpers
(``ops/beamsearch.py``: ``_lexsort`` for the 3-key sort, ``_smallest``
for top-k) beside ``torch.sort`` and ``torch.topk``.

Usage: python -m asr_decoder_tpu_torch.tools.perf.bench_dma_variants
       [--device cuda|cpu] [--rows S] [--nidx N] [--repeats R]
       [--sort-batch B] [--sort-div D]
"""

from __future__ import annotations

import argparse

import torch

from asr_decoder_tpu_torch.ops.beamsearch import _lexsort, _smallest
from asr_decoder_tpu_torch.tools.perf._common import (device_arg,
                                                      device_line, gather_fn,
                                                      open_device,
                                                      paired_line, paired_ms,
                                                      time_loop)
from asr_decoder_tpu_torch.tools.perf.bench_row_gather import bench

S = 2_000_000
NIDX = 131_072
R = 20
PAIRS = 10
SETS = 16        # index sets a paired loop cycles through
WIDTHS = (128, 256, 512)
SORTS = [  # (N, keys, note) at B = 32: the JAX tool's shapes
    (32768, 3, "(v2 emit)"),
    (32768, 1, "(cost-sort)"),
    (8192, 1, ""),
    (4096, 3, "(dedup)"),
    (4096, 1, ""),
    (20480, 1, "(closure)"),
]


def make_dma(W):
    """Row gather of a W-lane table, every row."""
    return gather_fn(W)


def make_dma_dyn(W, nlive):
    """Row gather of a W-lane table for rows ``i < nlive`` only; the rest
    of the output is left unwritten."""
    return gather_fn(W, nlive)


def seeded_inputs(W, SW, nidx, device):
    """The seeded ``[SW, W]`` table and ``nidx`` indices, made on the
    device."""
    table = torch.randint(0, 127, (SW, W), dtype=torch.int32, device=device,
                          generator=torch.Generator(device).manual_seed(0))
    idx = torch.randint(0, SW, (nidx,), dtype=torch.int32, device=device,
                        generator=torch.Generator(device).manual_seed(1))
    return table, idx


def bench_gather(fn, W, label, SW=None, *, rows=S, nidx=NIDX, repeats=R,
                 device):
    """Chained-call timing of ``fn`` over a fresh seeded ``[SW, W]`` table
    made on the device (``SW`` defaults to ``rows``)."""
    table, idx = seeded_inputs(W, SW or rows, nidx, device)
    return bench(fn, table, idx, label, repeats)


def pair_gather(fn, W, nlive, label, *, rows=S, nidx=NIDX, repeats=R,
                device):
    """``fn`` and ``torch.index_select`` over the first ``nlive`` indices,
    on the seeded ``[rows, W]`` table, in ``PAIRS`` alternating pairs of
    ``repeats`` calls each (device time of a CUDA-graph replay on a card,
    the host clock on the CPU); prints one line, returns the result.
    Successive calls take the next of ``SETS`` index sets, so that at the
    full size the rows come from HBM, not from the L2."""
    table, idx = seeded_inputs(W, rows, nidx, device)
    gen = torch.Generator(device).manual_seed(3)
    idxs = [idx] + [torch.randint(0, rows, (nidx,), dtype=torch.int32,
                                  device=device, generator=gen)
                    for _ in range(SETS - 1)]
    live_idxs = [i[:nlive] for i in idxs]
    it = iter(range(1 << 30))

    def timer(f):
        eager, graph = time_loop(lambda: [f() for _ in range(repeats)],
                                 device, repeats)
        return eager if graph is None else graph
    p = paired_ms(lambda: fn(table, idxs[next(it) % SETS]),
                  lambda: torch.index_select(
                      table, 0, live_idxs[next(it) % SETS]), PAIRS, timer)
    print(paired_line(label, p), flush=True)
    return p


def bench_sort(*, batch=32, div=1, repeats=R, device):
    """The search's sort shapes, chained through the sorted key; the
    3-key sort is the v2 relax's ``(dst, cost, idx)`` order."""
    gen = torch.Generator(device).manual_seed(2)
    rows = []

    def report(label, loop):
        eager, graph = time_loop(loop, device, repeats)
        g = "" if graph is None else f"  graph {graph:8.3f} ms"
        print(f"{label:42s} eager {eager:8.3f} ms{g}", flush=True)
        rows.append((label, eager, graph))

    for N, nk, note in SORTS:
        N //= div
        label = f"sort {nk}key [{batch},{N}] {note}"
        key = torch.rand((batch, N), generator=gen, device=device)
        dst = torch.randint(0, S, (batch, N), dtype=torch.int32,
                            generator=gen, device=device)
        idx = torch.arange(N, dtype=torch.int32,
                           device=device).expand(batch, N)

        def loop(key=key, dst=dst, idx=idx, nk=nk):
            carry = key
            for _ in range(repeats):
                if nk == 3:
                    _, out, _ = _lexsort((dst,), carry, idx)
                else:
                    out, order = torch.sort(carry, dim=1)
                    # the JAX sort's two payload operands
                    _ = dst.gather(1, order), idx.gather(1, order)
                carry = out + 1e-6
            return carry
        report(label, loop)

    n, k = 32768 // div, 4096 // div
    key = torch.rand((batch, n), generator=gen, device=device)
    for name, top in (("_smallest", lambda c: -_smallest(-c, k)[0]),
                      ("torch.topk", lambda c: torch.topk(c, k, dim=1)[0])):
        def loop(top=top):
            carry = key
            for _ in range(repeats):
                v = top(carry)
                carry = torch.nn.functional.pad(v, (0, n - k)) + 1e-6
            return carry
        report(f"top_k {n}->{k} [{batch}] ({name})", loop)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--rows", type=int, default=S)
    ap.add_argument("--nidx", type=int, default=NIDX)
    ap.add_argument("--repeats", type=int, default=R)
    ap.add_argument("--sort-batch", type=int, default=32)
    ap.add_argument("--sort-div", type=int, default=1,
                    help="divide every sort width by this (smoke runs)")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    print(device_line(dev), flush=True)
    sizes = dict(rows=args.rows, nidx=args.nidx, repeats=args.repeats,
                 device=dev)
    print("== sorts ==")
    bench_sort(batch=args.sort_batch, div=args.sort_div,
               repeats=args.repeats, device=dev)
    print("== row gather width scaling ==")
    for W in WIDTHS:
        bench_gather(make_dma(W), W, f"dma W={W} ({W * 4}B rows)", **sizes)
        bench_gather(lambda t, i: t[i], W, f"plain W={W}", **sizes)
        pair_gather(make_dma(W), W, args.nidx, f"pair W={W}", **sizes)
    print("== row gather dynamic live count (W=128) ==")
    for nlive in (args.nidx, args.nidx // 4, args.nidx // 16):
        bench_gather(make_dma_dyn(128, nlive), 128,
                     f"dma W=128 live={nlive}", **sizes)
        pair_gather(make_dma_dyn(128, nlive), 128, nlive,
                    f"pair W=128 live={nlive}", **sizes)
    print("== plain gather, narrow rows ==")
    bench_gather(lambda t, i: t[i], 32, f"plain [{args.rows},32]", **sizes)
    bench_gather(lambda t, i: t[i], 32, f"plain [{args.rows // 8},32]",
                 SW=args.rows // 8, **sizes)


if __name__ == "__main__":
    main()
