"""The v3 search's best-path traceback where its logs lie: one launch walks
every row asked for and returns only the paths.

Two callers keep v3 logs on a CUDA device.  ``TorchBeamSearch.traceback``
walks an offline batch (its ``[T, S, B, K]`` logs) with ``best_paths``;
the arena of ``serving/batcher.py`` keeps each channel's logs on the card
in a pool of pages (``serving/logstore.py``: ``[NP, P, S, K]`` logs and
``[NP, P, K]`` snapshots, a row's pages listed in a host page table
``[B, M]``), written a tick at a time by ``store_frames``, and walks the
channels of a server round with ``best_paths_rows``, each row over its own
frame count.  Logs on the host (the v2, CLG and BigLM searches' per-channel
copies, host logs of any caller) keep the host walk,
``TorchBeamSearch._walk_v3``.  The result is a packed i32 ``[B, HEAD +
cap]``: per row the path length (-1 where the logs do not hold a walkable
path), the cost's f32 bits, ``reached_final``, then the original arc ids in
backward order; words past the length are unspecified.

On a CUDA tensor the wrappers launch the kernels of ``csrc/traceback.cu``;
on a CPU tensor they run the plain versions, which compute the same
functions in PyTorch.  They replace no TPU kernel: the JAX package walks on
the host (``TpuBeamSearch._traceback_v3``).
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

# kernel launches from this process (CUDA tensors only), of the offline
# entry (``best_paths``), of the store's walk (``best_paths_rows``) and of
# its write (``store_frames``); callers reset them
launches = 0
row_launches = 0
store_launches = 0


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


@functools.cache
def _rows_kernel():
    fn = load_library("traceback").traceback_rows_i32
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 15 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _store_kernel():
    fn = load_library("traceback").store_frames_i32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + \
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


def _upload(device, idx: np.ndarray) -> torch.Tensor:
    """A host int array as i32 on ``device`` (a pinned copy on a card, so
    the upload does not wait)."""
    host = torch.from_numpy(np.ascontiguousarray(idx, np.int32))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _pages_of(pages, P: int, NP: int, rows, ends) -> np.ndarray:
    """The page lists ``pages[rows]`` (i64[n, M]) of a host page table
    ``pages`` [B, M], once every page that frames ``[0, ends[i])`` of row
    ``rows[i]`` lie in is checked to be one of the pool's ``NP``."""
    pages = np.asarray(pages)
    if pages.ndim != 2:
        raise ValueError("the page table must be [B, M]")
    B, M = pages.shape
    if ((rows < 0) | (rows >= B)).any():
        raise ValueError(f"rows outside the store's {B}")
    need = -(-ends // P)
    if ((ends < 0) | (need > M)).any():
        raise ValueError(f"frames outside the page table's {M} pages of "
                         f"{P}")
    held = pages[rows].astype(np.int64)
    used = np.arange(M) < need[:, None]
    if (used & ((held < 0) | (held >= NP))).any():
        raise ValueError(f"a row's frames lie past the pages it holds, or "
                         f"in a page outside the pool's {NP}")
    return held


def _check_pool(prev, aid, snap) -> tuple[int, int, int, int]:
    """The pool's (NP, P, S, K) from its leaves."""
    if prev.dim() != 4 or aid.shape != prev.shape:
        raise ValueError(f"need prev and aid [NP, P, S, K], got "
                         f"{tuple(prev.shape)} and {tuple(aid.shape)}")
    NP, P, S, K = prev.shape
    if snap.shape != (NP, P, K):
        raise ValueError(f"need snap [{NP}, {P}, {K}], got "
                         f"{tuple(snap.shape)}")
    return NP, P, S, K


def _dense(leaf: torch.Tensor, held: np.ndarray, T: int) -> torch.Tensor:
    """Frames ``[0, T)`` of each row's pages ``held`` [n, M] as dense
    ``[T, n, ...]`` (a frame past a row's pages reads page 0)."""
    P = leaf.shape[1]
    t = np.arange(T)
    g = held[:, t // P].clip(min=0) * P + t % P
    return leaf.view(-1, *leaf.shape[2:])[torch.from_numpy(g.T)
                                          .to(leaf.device)]


def best_paths_rows(tables: WalkTables, tok_state: torch.Tensor,
                    tok_cost: torch.Tensor, prev: torch.Tensor,
                    aid: torch.Tensor, snap: torch.Tensor,
                    iprev: torch.Tensor, iaid: torch.Tensor,
                    isnap: torch.Tensor, pages, rows, lengths
                    ) -> torch.Tensor:
    """The best paths of rows ``rows`` (host ints) of a paged log store, row
    ``rows[i]`` over its first ``lengths[i]`` frames: the beam
    ``tok_state`` i32[B, K], ``tok_cost`` f32[B, K]; the pool's ``prev``
    and ``aid`` i32[NP, P, S, K] and snapshots ``snap`` i32[NP, P, K]; the
    init log's one row, which every row shares: ``iprev``, ``iaid``
    i32[Si, 1, K], ``isnap`` i32[1, K]; all on the tables' device; the host
    page table ``pages`` [B, M] (row b's frame t in page ``pages[b, t //
    P]`` at ``t % P``).  Returns i32[len(rows), HEAD +
    capacity(max(lengths))] in the order of ``rows`` (module doc)."""
    NP, P, S, K = _check_pool(prev, aid, snap)
    Si, B = iprev.shape[0], len(tok_state)
    if iprev.shape[1:] != (1, K) or isnap.shape != (1, K):
        raise ValueError("the init log must be one row: [Si, 1, K], [1, K]")
    # shapes, stages, dtypes and devices as best_paths checks them, over
    # none of the pool's frames
    _check(tables, tok_state, tok_cost,
           *(t[:0].view(0, S, 1, K).expand(0, S, B, K) for t in (prev, aid)),
           snap[:0].view(0, 1, K).expand(0, B, K), iprev.expand(Si, B, K),
           iaid.expand(Si, B, K), isnap.expand(B, K))
    rows = np.asarray(rows, np.int64).reshape(-1)
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    if rows.shape != lengths.shape:
        raise ValueError("one length a row")
    held = _pages_of(pages, P, NP, rows, lengths)
    n = len(rows)
    Tmax = int(lengths.max()) if n else 0
    device = tables.em_offset.device
    if device.type == "cpu":
        r = torch.from_numpy(rows)
        return best_paths_plain(
            tables, tok_state[r], tok_cost[r],
            _dense(prev, held, Tmax).permute(0, 2, 1, 3),
            _dense(aid, held, Tmax).permute(0, 2, 1, 3),
            _dense(snap, held, Tmax), iprev.expand(Si, n, K),
            iaid.expand(Si, n, K), isnap.expand(n, K),
            lengths=torch.from_numpy(lengths))
    if device.type != "cuda":
        raise ValueError(f"no traceback kernel for device {device}")
    cap = capacity(tables, Tmax)
    if HEAD + cap >= 2**31:
        raise ValueError(f"traceback paths out of range: T={Tmax} "
                         f"cap={cap}")
    out = torch.empty((n, HEAD + cap), dtype=torch.int32, device=device)
    if not n:
        return out
    idx = _upload(device, np.concatenate([rows[:, None], lengths[:, None],
                                          held], axis=1))
    ins = [t.contiguous() for t in (tok_state, tok_cost, prev, aid, snap,
                                    iaid, isnap)]
    global row_launches
    with torch.cuda.device(device):
        err = _rows_kernel()(
            *(t.data_ptr() for t in (*ins, *tables[:6], out, idx)),
            n, held.shape[1], P, S, Si, B, K, tables.A, tables.C,
            tables.em_offset.numel(), tables.em_dst.numel(),
            tables.clo_path_off.numel() - 1, tables.start,
            tables.final_state, cap,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"traceback rows kernel launch failed: CUDA "
                           f"error {err}")
    row_launches += 1
    return out


def _store_check(pool, log, loglikes, pages, rows, offs, valid):
    """The pool's and the tick's leaves agree, and every row's frames lie
    in pages it holds; returns (host rows, offs, valid, their page
    lists)."""
    if len(pool) != 4 or len(log) != 4:
        raise ValueError("need the four v3 log leaves (prev, aid, snapshot "
                         "states and costs)")
    NP, P, S, K = _check_pool(*pool[:3])
    F, B = log[0].shape[0], log[0].shape[2]
    for d, s in zip(pool, log):
        if d.shape[:2] != (NP, P) or s.shape[0] != F \
                or d.shape[2:] != s.shape[1:-2] + s.shape[-1:] \
                or s.shape[-2] != B or d.dtype != s.dtype \
                or d.device != s.device or d.element_size() != 4:
            raise ValueError("pool and log leaves disagree")
    if loglikes.shape[:2] != (B, F) or loglikes.dtype != torch.float32 \
            or loglikes.device != pool[0].device:
        raise ValueError(f"loglikes must be f32[{B}, {F}, V] on the "
                         f"pool's device")
    rows, offs, valid = (np.asarray(x, np.int64).reshape(-1)
                         for x in (rows, offs, valid))
    if not rows.shape == offs.shape == valid.shape:
        raise ValueError("one offset and one count a row")
    if ((rows < 0) | (rows >= B) | (offs < 0) | (valid < 0)
            | (valid > F)).any():
        raise ValueError(f"rows outside the tick's {B}, or counts outside "
                         f"its {F} frames")
    return rows, offs, valid, _pages_of(pages, P, NP, rows, offs + valid)


def store_frames(pool, log, loglikes: torch.Tensor, pages, rows, offs,
                 valid) -> torch.Tensor:
    """Write a tick's log frames into a paged log store and pack its rows'
    loglikes: for each i, frames ``[0, valid[i])`` of row ``rows[i]`` of
    ``log`` (the v3 leaves: prev and aid i32[F, S, B, K], snapshot states
    i32 and costs f32 [F, B, K]) into ``pool`` (the same leaves in pages:
    [NP, P, S, K] and [NP, P, K]) at the row's frames ``offs[i]`` on, as
    the host page table ``pages`` [B, M] places them, in place.  ``rows``,
    ``offs`` and ``valid`` are host ints.  Returns the packed loglikes
    f32[n, F, V]: row i holds ``loglikes[rows[i], :valid[i]]`` (later
    frames unspecified)."""
    rows, offs, valid, held = _store_check(pool, log, loglikes, pages, rows,
                                           offs, valid)
    device = pool[0].device
    if device.type == "cpu":
        return store_frames_plain(pool, log, loglikes, pages, rows, offs,
                                  valid)
    if device.type != "cuda":
        raise ValueError(f"no store kernel for device {device}")
    n = len(rows)
    (F, S, B, K), V, P = log[0].shape, loglikes.shape[2], pool[0].shape[1]
    packed = torch.empty((n, F, V), dtype=torch.float32, device=device)
    if not n or not F:
        return packed
    idx = _upload(device, np.concatenate(
        [rows[:, None], offs[:, None], valid[:, None], held], axis=1))
    src = [t.contiguous() for t in (*log, loglikes)]
    if not all(t.is_contiguous() for t in pool):
        raise ValueError("the pool's leaves must be contiguous")
    global store_launches
    with torch.cuda.device(device):
        err = _store_kernel()(
            *(t.data_ptr() for t in (*src[:4], *pool, src[4], packed, idx)),
            n, F, S, B, K, V, P, held.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"store kernel launch failed: CUDA error {err}")
    store_launches += 1
    return packed


def store_frames_plain(pool, log, loglikes, pages, rows, offs, valid
                       ) -> torch.Tensor:
    """The store kernel's plain PyTorch version (CPU path and reference):
    one indexed copy a row and leaf.  Packed frames past a row's count are
    0."""
    n, (F, V), P = len(rows), loglikes.shape[1:], pool[0].shape[1]
    packed = loglikes.new_zeros((n, F, V))
    for i, (r, o, v) in enumerate(zip(rows, offs, valid)):
        t = np.arange(o, o + v)
        g = torch.from_numpy(np.asarray(pages)[r, t // P].astype(np.int64)
                             * P + t % P).to(pool[0].device)
        for d, s in zip(pool, log):
            d.view(-1, *d.shape[2:])[g] = s[:v, ..., r, :]
        packed[i, :v] = loglikes[r, :v]
    return packed


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
                     snap, iprev, iaid, isnap, lengths=None) -> torch.Tensor:
    """The kernels' plain PyTorch version (CPU path and reference): the
    slot chain walked for all rows at once, frame by frame, then every
    frame's arc lookups at once and the paths laid out with
    ``repeat_interleave``.  ``lengths`` (i64[B], default T each): row b
    walks its first ``lengths[b]`` frames, as the store's walk does.
    Words past a row's length are 0."""
    T, S, B, K = prev.shape
    Si = iprev.shape[0]
    tb = tables
    device = tok_state.device
    A, C = tb.A, max(tb.C, 1)
    rows = torch.arange(B, device=device)
    bad = torch.zeros(B, dtype=torch.bool, device=device)
    lengths = (torch.full((B,), T, device=device) if lengths is None
               else lengths.to(device))

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
        live = lengths > t             # rows whose walk has reached frame t
        if S == 2:
            fi1s[t] = torch.where(live, aid[t, 1, rows, slot], -1)
            nxt = prev[t, 1, rows, slot].long()
            bad |= live & ((nxt < 0) | (nxt >= K))
            slot = torch.where(live, nxt.clamp(0, K - 1), slot)
        fi = aid[t, 0, rows, slot].long()
        fis[t] = torch.where(live, fi, -1)
        nxt = torch.where(fi >= 0, fi // A, prev[t, 0, rows, slot].long())
        bad |= live & ((nxt < 0) | (nxt >= K) | ((fi1s[t] >= 0) & (fi < 0)))
        slot = torch.where(live, nxt.clamp(0, K - 1), slot)
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
