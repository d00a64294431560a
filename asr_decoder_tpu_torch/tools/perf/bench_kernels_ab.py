"""A/B of the search kernels: this checkout's gather and fetch against
another build of their sources, in alternating turns on one card.

The other build is a ``csrc/`` directory with the fetch's C interface
``fetch_records_i32(table, state, live, out, S, L, B, K, stream)`` and
either gather interface: the multi-table ``batched_table_gather_many_i32
(tables, outs, P, idx, B, V, N, stream)`` (the port's ``csrc/`` since the
gather's redesign) or the one-table ``batched_table_gather_i32(table, idx,
out, B, V, N, stream)`` (before it, one call a table).  For a commit's
sources:

    mkdir -p build/other && git archive <commit> asr_decoder_tpu_torch/csrc \\
        | tar -x -C build/other
    python -m asr_decoder_tpu_torch.tools.perf.bench_kernels_ab \\
        --other build/other/asr_decoder_tpu_torch/csrc

Each shape is checked bit-exact between the two builds (on the live rows
where a count leaves some dead), then timed in ``TURNS`` rounds of other,
this, this, other (device time: calls captured in a CUDA graph and
replayed, ``_common.time_loop``); a row prints each build's median and
this build's time over the other's: the gather at the search's shapes;
the fetch with every token live, cycling 64 index sets, at the 32, 64 and
128-lane records; the 128-512-lane row gathers of ``tools/perf``, every
row live and at the dynamic counts of ``make_dma_dyn``, cycling 16 index
sets (a loop's rows then overflow the 50 MB L2 and come from HBM).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from asr_decoder_tpu_torch.ops import fetch, gather
from asr_decoder_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, nvcc
from asr_decoder_tpu_torch.tools.perf._common import (device_line,
                                                      open_device, time_loop)

GATHER = [(16, 1024, 512, 1), (16, 5120, 512, 1), (16, 2048, 4096, 1),
          (32, 2048, 4096, 1), (32, 65536, 4096, 1), (32, 32768, 8192, 1),
          (32, 8192, 4096, 1), (256, 2048, 4096, 1), (16, 1024, 512, 2),
          (16, 1024, 512, 3), (16, 4096, 4096, 7)]    # (B, V, N, tables)
FETCH = [(200_001, 32, 16, 512), (200_001, 32, 256, 512),
         (2_500_000, 32, 16, 512), (2_500_000, 32, 256, 512),
         (2_500_000, 32, 32, 4096), (2_500_000, 64, 16, 512),
         (2_500_000, 64, 256, 512), (2_500_000, 64, 32, 4096),
         (2_500_000, 128, 16, 512), (2_500_000, 128, 256, 512),
         (2_500_000, 128, 32, 4096)]                 # (S, L, B, K)
ROWS, NIDX = 2_000_000, 131_072
ROW_CASES = [(128, (NIDX, 32_768, 8_192)), (256, (NIDX,)),
             (512, (NIDX,))]                          # (lanes, live counts)
ROW_SETS = 16                # index sets a timed row-gather loop cycles
TURNS = 3


def other_kernels(csrc: Path):
    """(gather, fetch) of the other build, compiled into BUILD_DIR:
    ``gather(tables, idx) -> outs`` and ``fetch(table, state, live)``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("gather", "fetch"):
        out = BUILD_DIR / f"other_{name}.so"
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
        libs[name] = ctypes.CDLL(str(out))
    f = libs["fetch"].fetch_records_i32
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def empty_like_idx(ts, i):
        return [torch.empty(i.shape, dtype=t.dtype, device=t.device)
                for t in ts]

    if hasattr(libs["gather"], "batched_table_gather_many_i32"):
        g = libs["gather"].batched_table_gather_many_i32
        g.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        g.restype = ctypes.c_int

        def gather_all(ts, i):
            outs = empty_like_idx(ts, i)
            ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
            optrs = (ctypes.c_void_p * len(outs))(
                *(o.data_ptr() for o in outs))
            if g(ptrs, optrs, len(ts), i.data_ptr(), *ts[0].shape,
                 i.shape[1], stream()):
                raise RuntimeError("other gather kernel failed to launch")
            return outs
    else:
        g = libs["gather"].batched_table_gather_i32
        g.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        g.restype = ctypes.c_int

        def gather_all(ts, i):
            outs = empty_like_idx(ts, i)
            for t, o in zip(ts, outs):
                if g(t.data_ptr(), i.data_ptr(), o.data_ptr(), *t.shape,
                     i.shape[1], stream()):
                    raise RuntimeError("other gather kernel failed to "
                                       "launch")
            return outs

    def fetch_rows(t, s, lv):
        o = torch.empty((*s.shape, t.shape[1]), dtype=torch.int32,
                        device=t.device)
        if f(t.data_ptr(), s.data_ptr(), lv.data_ptr(), o.data_ptr(),
             *t.shape, *s.shape, stream()):
            raise RuntimeError("other fetch kernel failed to launch")
        return o
    return gather_all, fetch_rows


def ab(label: str, other, this, dev, calls: int = 20,
       replays: int = 20) -> None:
    """Device us a call in ``TURNS`` rounds of other / this / this / other;
    prints the two medians."""
    res = {"other": [], "this": []}
    for _ in range(TURNS):
        for name in ("other", "this", "this", "other"):
            fn = other if name == "other" else this
            res[name].append(time_loop(lambda: [fn() for _ in range(calls)],
                                       dev, calls, replays)[1] * 1e3)
    o, t = (float(np.median(res[k])) for k in ("other", "this"))
    print(f"{label}: other {o:.3f} us [{min(res['other']):.3f}, "
          f"{max(res['other']):.3f}], this {t:.3f} us "
          f"[{min(res['this']):.3f}, {max(res['this']):.3f}]; this / other "
          f"{t / o:.4f}", flush=True)


def same_live_rows(a: torch.Tensor, b: torch.Tensor,
                   live: torch.Tensor) -> bool:
    """``a`` and ``b`` [B, K, L] equal on the rows below ``live[b]``."""
    alive = (torch.arange(a.shape[1], device=a.device)[None, :]
             < live[:, None])
    return torch.equal(a[alive], b[alive])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc/ directory of the other build")
    args = ap.parse_args(argv)
    dev = open_device("cuda")
    print(device_line(dev), flush=True)
    other_gather, other_fetch = other_kernels(args.other)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, V, N, P in GATHER:
        ts = [torch.randn((B, V), generator=gen, device=dev)
              for _ in range(P)]
        i = torch.randint(0, V, (B, N), generator=gen, device=dev,
                          dtype=torch.int32)
        for a, b in zip(gather.batched_table_gather_many(ts, i),
                        other_gather(ts, i)):
            if not torch.equal(a, b):
                raise SystemExit(f"gather [{B},{V}]x[{B},{N}] differs")
        ab(f"gather [{B},{V}]x[{B},{N}] P={P}",
           lambda: other_gather(ts, i),
           lambda: gather.batched_table_gather_many(ts, i), dev)
    for S, L, B, K in FETCH:
        t = torch.randint(-2**31, 2**31 - 1, (S, L), generator=gen,
                          device=dev, dtype=torch.int32)
        states = [torch.randint(0, S, (B, K), generator=gen, device=dev,
                                dtype=torch.int32) for _ in range(64)]
        lv = torch.full((B,), K, dtype=torch.int32, device=dev)
        if not torch.equal(fetch.fetch_records(t, states[0], lv),
                           other_fetch(t, states[0], lv)):
            raise SystemExit(f"fetch [{S},{L}] B={B} K={K} differs")
        it = iter(range(1 << 30))
        ab(f"fetch [{S},{L}] B={B} K={K}",
           lambda: other_fetch(t, states[next(it) % 64], lv),
           lambda: fetch.fetch_records(t, states[next(it) % 64], lv), dev,
           calls=64, replays=5)
        del t, states
    idxs = [torch.randint(0, ROWS, (1, NIDX), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(ROW_SETS)]
    it = iter(range(1 << 30))
    for W, counts in ROW_CASES:
        t = torch.randint(-2**31, 2**31 - 1, (ROWS, W), generator=gen,
                          device=dev, dtype=torch.int32)
        for n in counts:
            lv = torch.tensor([n], dtype=torch.int32, device=dev)
            if not same_live_rows(fetch.fetch_records(t, idxs[0], lv),
                                  other_fetch(t, idxs[0], lv), lv):
                raise SystemExit(f"rows [{ROWS},{W}] x {NIDX} live {n} "
                                 f"differ")
            ab(f"rows [{ROWS},{W}] x {NIDX} live {n}",
               lambda: other_fetch(t, idxs[next(it) % ROW_SETS], lv),
               lambda: fetch.fetch_records(t, idxs[next(it) % ROW_SETS],
                                           lv), dev, calls=ROW_SETS,
               replays=5)
        del t

if __name__ == "__main__":
    main()
