"""Live-adaptive row fetch: the beam search's state-record fetch and the
flat row gather of the ``tools/perf`` microbenches.

Port of ``asr_decoder_tpu/ops/fetch.py``.  Each active beam token needs its
state's packed record (emitting arcs + ε-closure entries, field-major) from
the narrow ``[S, lanes]`` record table that
``ops/beamsearch.make_packed_graph`` builds.  The TPU's 128-lane page
packing is not carried over: it existed only because TPU HBM rows are
128-lane tiles.

On a CUDA tensor the wrapper launches the kernel of ``csrc/fetch.cu``,
which reads only the first ``live[b]`` tokens of each row (the beam is
kept live-prefix); on a CPU tensor it runs the plain version, which
fetches every row.  Rows from ``live[b]`` on are unspecified either way —
callers mask them by their own validity.

``row_gather`` is the same kernel as a flat gather ``out[i] = table[idx[i]]``
for ``i < count`` (B = 1, K = len(idx)): the counterpart of the TPU
microbench kernels ``make_dma_gather``, ``make_dma`` and ``make_dma_dyn``
(``tools/perf``), at 128-512 lanes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from asr_decoder_tpu_torch.ops._build import load_library

LANES = (32, 64, 128, 256, 512)

# kernel launches from this process (CUDA tensors only); callers reset it
launches = 0
# while this is a set, every launch adds its (S, L, B, K) to it
shapes: set | None = None


@functools.cache
def _kernel():
    fn = load_library("fetch").fetch_records_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fetch_plain(table: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version (CPU path and reference), with
    the kernel's clamp of out-of-range states into the table."""
    return table[state.clamp(0, table.shape[0] - 1)]


def fetch_records(table: torch.Tensor, state: torch.Tensor,
                  live: torch.Tensor) -> torch.Tensor:
    """Each token's state record: i32 table [S, L] (L in 32-512),
    i32 state [B, K] (negative = dead slot, read as row 0), i32 live [B]
    live-prefix lengths → i32 [B, K, L]."""
    if table.dim() != 2 or table.shape[1] not in LANES:
        raise ValueError(f"table must be [S, L] with L in {LANES}, got "
                         f"{tuple(table.shape)}")
    if state.dim() != 2 or live.shape != (state.shape[0],):
        raise ValueError(f"need state [B, K] and live [B], got "
                         f"{tuple(state.shape)} and {tuple(live.shape)}")
    for name, t in (("table", table), ("state", state), ("live", live)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, not {t.dtype}")
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on "
                             f"{table.device}")
    if table.device.type == "cpu":
        return fetch_plain(table, state)
    if table.device.type != "cuda":
        raise ValueError(f"no fetch kernel for device {table.device}")
    S, L = table.shape
    B, K = state.shape
    if S == 0 or B > 65535 or S * L >= 2**31 or B * K * L >= 2**31:
        raise ValueError(f"fetch shape out of range: S={S} L={L} B={B} "
                         f"K={K}")
    table = table.contiguous()
    state = state.contiguous()
    live = live.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((B, K, L), dtype=torch.int32, device=table.device)
    global launches
    with torch.cuda.device(table.device):
        err = _kernel()(table.data_ptr(), state.data_ptr(), live.data_ptr(),
                        out.data_ptr(), S, L, B, K,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fetch kernel launch failed: CUDA error {err}")
    launches += 1
    if shapes is not None:
        shapes.add((S, L, B, K))
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               count: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` for ``i < count[0]``: i32 table [S, L]
    (L in 32-512), i32 idx [N], i32 count [1] on the table's device (read
    by the kernel, so no host sync) → i32 [N, L]; rows from ``count`` on
    are unspecified.  One launch of the fetch kernel with B = 1."""
    if idx.dim() != 1:
        raise ValueError(f"idx must be [N], got {tuple(idx.shape)}")
    return fetch_records(table, idx[None], count)[0]
