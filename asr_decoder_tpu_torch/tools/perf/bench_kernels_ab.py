"""A/B of the search kernels: this checkout's gather and fetch against
another build of their sources, in alternating turns on one card.

The other build is a ``csrc/`` directory with the C interfaces the kernels
had before the multi-table gather: ``batched_table_gather_i32(table, idx,
out, B, V, N, stream)`` and ``fetch_records_i32(table, state, live, out, S,
L, B, K, stream)`` (the port's ``csrc/`` up to the redesign).  For a parent
commit's sources:

    mkdir -p build/other && git archive <commit> asr_decoder_tpu_torch/csrc \\
        | tar -x -C build/other
    python -m asr_decoder_tpu_torch.tools.perf.bench_kernels_ab \\
        --other build/other/asr_decoder_tpu_torch/csrc

Each shape is checked bit-exact between the two builds, then timed other,
this, this, other (device time: calls captured in a CUDA graph and
replayed, ``_common.time_loop``):
the gather at the search's shapes, one call of the other build a table
for the multi-table rows; the fetch with every token live, cycling 64
index sets; the 128-512-lane row gathers of ``tools/perf``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

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
         (2_500_000, 128, 16, 512)]                  # (S, L, B, K)
ROWS, NIDX = 2_000_000, 131_072


def other_kernels(csrc: Path):
    """(gather, fetch) of the other build, compiled into BUILD_DIR."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("gather", "fetch"):
        out = BUILD_DIR / f"other_{name}.so"
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
        libs[name] = ctypes.CDLL(str(out))
    g = libs["gather"].batched_table_gather_i32
    g.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    f = libs["fetch"].fetch_records_i32
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    g.restype = f.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def gather_one(t, i):
        o = torch.empty(i.shape, dtype=t.dtype, device=t.device)
        if g(t.data_ptr(), i.data_ptr(), o.data_ptr(), *t.shape,
             i.shape[1], stream()):
            raise RuntimeError("other gather kernel failed to launch")
        return o

    def fetch_rows(t, s, lv):
        o = torch.empty((*s.shape, t.shape[1]), dtype=torch.int32,
                        device=t.device)
        if f(t.data_ptr(), s.data_ptr(), lv.data_ptr(), o.data_ptr(),
             *t.shape, *s.shape, stream()):
            raise RuntimeError("other fetch kernel failed to launch")
        return o
    return gather_one, fetch_rows


def ab(label: str, other, this, dev, calls: int = 20,
       replays: int = 20) -> None:
    """Device us a call, other / this / this / other."""
    res = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        fn = other if name == "other" else this
        res[name].append(time_loop(lambda: [fn() for _ in range(calls)],
                                   dev, calls, replays)[1] * 1e3)
    print(f"{label}: other {res['other'][0]:.3f} {res['other'][1]:.3f} us, "
          f"this {res['this'][0]:.3f} {res['this'][1]:.3f} us")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc/ directory of the other build")
    args = ap.parse_args(argv)
    dev = open_device("cuda")
    print(device_line(dev))
    other_gather, other_fetch = other_kernels(args.other)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, V, N, P in GATHER:
        ts = [torch.randn((B, V), generator=gen, device=dev)
              for _ in range(P)]
        i = torch.randint(0, V, (B, N), generator=gen, device=dev,
                          dtype=torch.int32)
        for a, b in zip(gather.batched_table_gather_many(ts, i),
                        [other_gather(t, i) for t in ts]):
            if not torch.equal(a, b):
                raise SystemExit(f"gather [{B},{V}]x[{B},{N}] differs")
        ab(f"gather [{B},{V}]x[{B},{N}] P={P}",
           lambda: [other_gather(t, i) for t in ts],
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
    for W in (128, 256, 512):
        t = torch.randint(-2**31, 2**31 - 1, (ROWS, W), generator=gen,
                          device=dev, dtype=torch.int32)
        idx = torch.randint(0, ROWS, (1, NIDX), generator=gen, device=dev,
                            dtype=torch.int32)
        lv = torch.tensor([NIDX], dtype=torch.int32, device=dev)
        ab(f"rows [{ROWS},{W}] x {NIDX}", lambda: other_fetch(t, idx, lv),
           lambda: fetch.fetch_records(t, idx, lv), dev, calls=10,
           replays=5)
        del t


if __name__ == "__main__":
    main()
