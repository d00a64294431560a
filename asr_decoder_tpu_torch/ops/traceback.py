"""The v3 search's best-path traceback where its logs lie: one launch walks
every row of a batch and returns only the paths.

``TorchBeamSearch.traceback`` calls this when the logs are on a CUDA device
(the offline batches, whose ``[T, S, B, K]`` logs stay on the card); logs on
the host (the server's and the session's per-channel copies, every CPU
caller) keep the host walk, ``TorchBeamSearch._walk_v3``.  The result is a
packed i32 ``[B, HEAD + cap]``: per row the path length (-1 where the logs
do not hold a walkable path), the cost's f32 bits, ``reached_final``, then
the original arc ids in backward order; words past the length are
unspecified.

On a CUDA tensor the wrapper launches the kernel of ``csrc/traceback.cu``;
on a CPU tensor it runs the plain version, which computes the same function
in PyTorch, vectorised over the rows.  It replaces no TPU kernel: the JAX
package walks on the host (``TpuBeamSearch._traceback_v3``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from asr_decoder_tpu_torch.ops._build import load_library

HEAD = 3                  # length, cost bits, reached_final
LENGTH, COST, FINAL = range(HEAD)

# kernel launches from this process (CUDA tensors only); callers reset it
launches = 0


class WalkTables(NamedTuple):
    """The graph tables the walk reads, on one device: the emitting block
    (``em_offset`` i32[N], ``em_dst`` and ``em_arcid`` i32[E]) and the
    ε-closure entries with their backward-ordered paths (``clo_offset``
    i32[N], ``clo_path_off`` i64[Nclo + 1], ``clo_path_arcs`` i32[P])."""
    em_offset: torch.Tensor
    em_dst: torch.Tensor
    em_arcid: torch.Tensor
    clo_offset: torch.Tensor
    clo_path_off: torch.Tensor
    clo_path_arcs: torch.Tensor
    A: int                # emitting lanes a record
    C: int                # closure lanes a record (0: no closure stage)
    start: int
    final_state: int
    max_path: int         # longest closure path, in arcs


def walk_tables(dev, A: int, C: int, device) -> WalkTables:
    """``DeviceFst`` ``dev``'s walk tables on ``device`` (one upload)."""
    def to(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)
    path_off = np.asarray(dev.clo_path_off, np.int64)
    return WalkTables(
        em_offset=to(dev.em_offset, np.int32), em_dst=to(dev.em_dst, np.int32),
        em_arcid=to(dev.em_arcid, np.int32),
        clo_offset=to(dev.clo_offset, np.int32),
        clo_path_off=to(path_off, np.int64),
        clo_path_arcs=to(dev.clo_path_arcs, np.int32), A=int(A), C=int(C),
        start=int(dev.start), final_state=int(dev.final_state),
        max_path=int(np.diff(path_off).max()) if len(path_off) > 1 else 0)


def capacity(tables: WalkTables, T: int) -> int:
    """Arc words a row can need: a frame's closure path and emit arc, and
    the init closure path."""
    return T * (1 + tables.max_path) + tables.max_path


@functools.cache
def _kernel():
    fn = load_library("traceback").traceback_best_paths_i32
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 13 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(tables: WalkTables, tok_state, tok_cost, prev, aid, snap, iprev,
           iaid, isnap) -> tuple[int, int, int, int, int]:
    if prev.dim() != 4 or aid.shape != prev.shape:
        raise ValueError(f"need prev and aid [T, S, B, K], got "
                         f"{tuple(prev.shape)} and {tuple(aid.shape)}")
    T, S, B, K = prev.shape
    Si = iprev.shape[0]
    if snap.shape != (T, B, K) or tok_state.shape != (B, K) \
            or tok_cost.shape != (B, K) or isnap.shape != (B, K) \
            or iprev.shape != (Si, B, K) or iaid.shape != (Si, B, K):
        raise ValueError("logs, snapshots and final beam disagree in shape")
    if S != 1 + (tables.C > 0) or Si != (tables.C > 0):
        raise ValueError(f"{S} stages and {Si} init stages do not fit a "
                         f"graph with C = {tables.C}")
    for name, t in (("tok_state", tok_state), ("prev", prev), ("aid", aid),
                    ("snap", snap), ("iprev", iprev), ("iaid", iaid),
                    ("isnap", isnap), ("tok_cost", tok_cost)):
        want = torch.float32 if name == "tok_cost" else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, not {t.dtype}")
        if t.device != tables.em_offset.device:
            raise ValueError(f"{name} on {t.device}, tables on "
                             f"{tables.em_offset.device}")
    return T, S, Si, B, K


def best_paths(tables: WalkTables, tok_state: torch.Tensor,
               tok_cost: torch.Tensor, prev: torch.Tensor, aid: torch.Tensor,
               snap: torch.Tensor, iprev: torch.Tensor, iaid: torch.Tensor,
               isnap: torch.Tensor) -> torch.Tensor:
    """Every row's best path: final beam ``tok_state`` i32[B, K],
    ``tok_cost`` f32[B, K]; the frames' logs ``prev`` and ``aid``
    i32[T, S, B, K] and snapshots ``snap`` i32[T, B, K]; the init log
    ``iprev``, ``iaid`` i32[Si, B, K] and ``isnap`` i32[B, K]; all on the
    tables' device.  Returns i32[B, HEAD + capacity(T)] (module doc)."""
    T, S, Si, B, K = _check(tables, tok_state, tok_cost, prev, aid, snap,
                            iprev, iaid, isnap)
    device = tables.em_offset.device
    if device.type == "cpu":
        return best_paths_plain(tables, tok_state, tok_cost, prev, aid, snap,
                                iprev, iaid, isnap)
    if device.type != "cuda":
        raise ValueError(f"no traceback kernel for device {device}")
    cap = capacity(tables, T)
    if HEAD + cap >= 2**31:
        raise ValueError(f"traceback paths out of range: T={T} "
                         f"cap={cap}")
    ins = [t.contiguous() for t in (tok_state, tok_cost, prev, aid, snap,
                                    iaid, isnap)]
    out = torch.empty((B, HEAD + cap), dtype=torch.int32, device=device)
    tabs = tables[:6]                   # the tensors, in the kernel's order
    global launches
    with torch.cuda.device(device):
        err = _kernel()(
            *(t.data_ptr() for t in (*ins, *tabs, out)),
            T, S, Si, B, K, tables.A, tables.C,
            tables.em_offset.numel(), tables.em_dst.numel(),
            tables.clo_path_off.numel() - 1, tables.start,
            tables.final_state, cap,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"traceback kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def unpack(paths: np.ndarray):
    """Each row of a host copy of ``best_paths``' output as (original arc
    ids i32[n] in forward order, cost, reached_final); a row the walk
    refused raises ``AssertionError``."""
    costs = paths[:, COST].copy().view(np.float32)
    for b, row in enumerate(paths):
        n = int(row[LENGTH])
        if n < 0:
            raise AssertionError(
                f"row {b}: the logs hold no walkable path (a closure entry "
                f"above a stay slot, or an index outside the graph)")
        yield row[HEAD:HEAD + n][::-1], float(costs[b]), bool(row[FINAL])


def _final_slots(final_state: int, tok_state, tok_cost):
    """Each row's final slot: tokens on the final state first, then the
    least cost (NaN least, -0.0 equal to +0.0), then the lowest slot.
    Returns (slot i64[B], reached_final bool[B])."""
    B, K = tok_state.shape
    fin = tok_state == final_state
    reached = fin.any(dim=1)
    canon = torch.where(tok_cost == 0, torch.zeros_like(tok_cost), tok_cost)
    bits = canon.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    key = torch.where(torch.isnan(tok_cost), -2**32, key)
    key = torch.where(fin | ~reached[:, None], key, 2**33)
    slots = torch.arange(K, device=tok_state.device)
    return torch.argmin(key * K + slots, dim=1), reached


def best_paths_plain(tables: WalkTables, tok_state, tok_cost, prev, aid,
                     snap, iprev, iaid, isnap) -> torch.Tensor:
    """The kernel's plain PyTorch version (CPU path and reference): the
    slot chain walked for all rows at once, frame by frame, then every
    frame's arc lookups at once and the paths laid out with
    ``repeat_interleave``.  Words past a row's length are 0."""
    T, S, B, K = prev.shape
    Si = iprev.shape[0]
    tb = tables
    device = tok_state.device
    A, C = tb.A, max(tb.C, 1)
    rows = torch.arange(B, device=device)
    bad = torch.zeros(B, dtype=torch.bool, device=device)

    def take(table, idx, used):
        """``table[idx]`` where ``used``; an index outside the table there
        marks the row bad (and reads entry 0)."""
        ok = (idx >= 0) & (idx < table.numel())
        miss = used & ~ok
        bad.logical_or_(miss.any(dim=0) if miss.dim() == 2 else miss)
        return table[torch.where(used & ok, idx, 0)].long()

    slot, reached = _final_slots(tb.final_state, tok_state, tok_cost)
    cost = tok_cost[rows, slot]
    # the slot chain
    fi1s = torch.full((T, B), -1, dtype=torch.long, device=device)
    fis = torch.empty((T, B), dtype=torch.long, device=device)
    for t in range(T - 1, -1, -1):
        if S == 2:
            fi1s[t] = aid[t, 1, rows, slot]
            slot = prev[t, 1, rows, slot].long()
            bad |= (slot < 0) | (slot >= K)
            slot = slot.clamp(0, K - 1)
        fi = aid[t, 0, rows, slot].long()
        fis[t] = fi
        slot = torch.where(fi >= 0, fi // A, prev[t, 0, rows, slot].long())
        bad |= (slot < 0) | (slot >= K) | ((fi1s[t] >= 0) & (fi < 0))
        slot = slot.clamp(0, K - 1)
    init_entry = torch.full((B,), -1, dtype=torch.long, device=device)
    if Si:
        fi1 = iaid[0, rows, slot].long()
        init_entry = torch.where(fi1 >= 0, int(tb.clo_offset[tb.start])
                                 + fi1 % C, -1)
        miss = init_entry >= tb.clo_path_off.numel() - 1
        bad |= miss
        init_entry = torch.where(miss, -1, init_entry)
    # the arc lookups, every frame at once
    priors = torch.cat([isnap[None], snap[:-1]]) if T else snap
    emit = fis >= 0
    pslot = torch.where(emit, fis // A, 0).clamp(0, K - 1)
    ps = priors.gather(2, pslot[:, :, None])[:, :, 0].long()
    ai = torch.where(emit & (ps >= 0) & (ps < tb.em_offset.numel()),
                     take(tb.em_offset, ps, emit) + fis % A, -1)
    arcs = torch.where(emit, take(tb.em_arcid, ai, emit), -1)
    clo = emit & (fi1s >= 0)
    sd = take(tb.em_dst, ai, clo)
    entry = torch.where(clo & (sd >= 0) & (sd < tb.clo_offset.numel()),
                        take(tb.clo_offset, sd, clo) + fi1s % C, -1)
    nclo = tb.clo_path_off.numel() - 1
    bad |= (clo & ((entry < 0) | (entry >= nclo))).any(dim=0)
    entry = torch.where(clo & (entry < nclo), entry, -1)
    # the layout: per row, frames T-1..0 (closure path, then emit arc),
    # then the init closure path
    ent = torch.cat([entry.flip(0), init_entry[None]]).t()      # [B, T+1]
    arc = torch.cat([arcs.flip(0), torch.full_like(init_entry, -1)[None]]
                    ).t()
    # padded by one so that a clamped index reads inside them
    off = torch.cat([tb.clo_path_off, tb.clo_path_off[-1:]])
    path_arcs = torch.cat([tb.clo_path_arcs, tb.clo_path_arcs.new_zeros(1)])
    e0 = ent.clamp(0, max(nclo - 1, 0))
    plen = torch.where(ent >= 0, off[e0 + 1] - off[e0], 0)
    n = plen + (arc >= 0)
    lengths = n.sum(dim=1)
    cap = capacity(tb, T)
    bad |= lengths > cap
    # item j of step (b, u): path arc j (j < plen), else the emit arc
    steps = torch.arange(B * (T + 1), device=device)
    step_of = torch.repeat_interleave(steps, n.reshape(-1))
    first = torch.cumsum(n.reshape(-1), 0) - n.reshape(-1)
    j = torch.arange(step_of.numel(), device=device) - first[step_of]
    e_flat, a_flat = ent.reshape(-1)[step_of], arc.reshape(-1)[step_of]
    in_path = j < plen.reshape(-1)[step_of]
    vals = torch.where(
        in_path, path_arcs[torch.where(
            in_path, off[e_flat.clamp(min=0)] + j, 0)].long(), a_flat)
    row_of = step_of // (T + 1)
    row_first = torch.cumsum(lengths, 0) - lengths
    col = torch.arange(step_of.numel(), device=device) - row_first[row_of]
    out = torch.zeros((B, HEAD + cap), dtype=torch.int32, device=device)
    keep = ~bad[row_of] & (col < cap)
    out[row_of[keep], HEAD + col[keep]] = vals[keep].to(torch.int32)
    out[:, LENGTH] = torch.where(bad, -1, lengths).to(torch.int32)
    out[:, COST] = cost.view(torch.int32)
    out[:, FINAL] = reached.to(torch.int32)
    return out
