"""Batched small-table gather: ``out[b, n] = table[b, idx[b, n]]``, for one
table or for up to eight tables that share the index.

Port of ``asr_decoder_tpu/ops/gather.py``.  The beam search calls this for
the acoustic-score lookup (one log-likelihood per arc candidate) and for
every re-ordering gather inside the relax; where one index re-orders
several tables (cost, state and candidate index of the winners; the BigLM
compaction's operands) it makes one call of ``batched_table_gather_many``.
On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/gather.cu``; on a CPU tensor it runs the plain version.  The
tensor's device decides — there is no knob.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from asr_decoder_tpu_torch.ops._build import load_library

MAX_TABLES = 8

# kernel launches from this process (CUDA tensors only); callers reset it
launches = 0
# while this is a set, every launch adds its (B, V, N, table dtypes) to it
shapes: set | None = None


@functools.cache
def _kernel():
    fn = load_library("gather").batched_table_gather_many_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_plain_many(tables: Sequence[torch.Tensor],
                      idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The kernel's plain PyTorch version (CPU path and reference)."""
    idx = idx.long()
    return tuple(torch.gather(t, 1, idx) for t in tables)


def batched_table_gather(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """``out[b, n] = table[b, idx[b, n]]`` — f32/i32 table [B, V], i32
    idx [B, N] with values in [0, V); returns [B, N] of the table's dtype.
    """
    return batched_table_gather_many((table,), idx)[0]


def batched_table_gather_many(tables: Sequence[torch.Tensor],
                              idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``out_p[b, n] = tables[p][b, idx[b, n]]`` for 1 to 8 tables of one
    shape [B, V], each f32 or i32, and i32 idx [B, N] with values in
    [0, V); one kernel launch on a GPU.  Returns the P outputs [B, N], each
    of its table's dtype."""
    tables = tuple(tables)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"need 1 to {MAX_TABLES} tables, got {len(tables)}")
    if idx.dim() != 2:
        raise ValueError(f"need idx [B, N], got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    shape = tables[0].shape
    for t in tables:
        if t.dim() != 2 or t.shape != shape or t.shape[0] != idx.shape[0]:
            raise ValueError(f"need tables [B, V] of one shape and idx "
                             f"[B, N], got {tuple(t.shape)} and "
                             f"{tuple(idx.shape)}")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"table must be float32 or int32, not {t.dtype}")
        if t.device != idx.device:
            raise ValueError(f"table on {t.device}, idx on {idx.device}")
    if idx.device.type == "cpu":
        return gather_plain_many(tables, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {idx.device}")
    B, V = shape
    N = idx.shape[1]
    if B > 65535 or V == 0 or max(B * V, B * N) >= 2**31:
        raise ValueError(f"gather shape out of range: B={B} V={V} N={N}")
    tables = [t.contiguous() for t in tables]
    idx = idx.contiguous()
    outs = [torch.empty((B, N), dtype=t.dtype, device=t.device)
            for t in tables]
    ptrs = (ctypes.c_void_p * len(tables))(
        *(t.view(torch.int32).data_ptr() for t in tables))
    optrs = (ctypes.c_void_p * len(outs))(
        *(o.view(torch.int32).data_ptr() for o in outs))
    global launches
    with torch.cuda.device(idx.device):
        err = _kernel()(ptrs, optrs, len(tables), idx.data_ptr(), B, V, N,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")
    launches += 1
    if shapes is not None:
        shapes.add((B, V, N, tuple(t.dtype for t in tables)))
    return tuple(outs)
