"""Batched frame-synchronous WFST Viterbi beam search in PyTorch.

Port of ``asr_decoder_tpu/ops/beamsearch.py`` — the reference decoder's
``ProcessEmitting`` / ``ProcessNonemitting`` / ``GetCutoff`` /
``FindOrAddToken`` (ref: src/my-decoder/online-decoder-base-inl.h:89-437)
as a dense ``[B, K]`` token beam per utterance.  Both engines of the JAX
package are here, chosen by the same ``auto`` rules:

  * **v3** (``relax_impl=topk``, closure ε mode): each frame is one
    live-adaptive record fetch (``ops/fetch.py``), a flat ``[B, K·A]``
    candidate field, a top-k-first relax (``_relax_topk``), then one more
    fetch and relax over the precomputed ε-closure entries.
  * **v2** (``relax_impl=sort``): the beam states' padded arc-record rows
    are read by plain indexing, every candidate goes through a full-width
    sort by destination (``_relax_and_prune``), and ε is one closure stage
    (closure mode) or E bounded relaxation sweeps over the ε arcs (sweeps
    mode, E = the graph's ε depth).

The search is plain functions on tensors; every function takes its
tensors on one device and runs there.  The hand-written kernels are the
record fetch and the batched gather (``ops/gather.py``); sorting and the
elementwise work are PyTorch ops.

Tie order follows JAX exactly, because words and costs are held to the JAX
engine bit for bit:

  * ``lax.top_k(-cost, k)`` ranks by IEEE total order (-0.0 before +0.0)
    and breaks ties by the lowest index — here a stable ascending sort of
    an int32 key that orders like the float's total order;
  * the multi-key ``lax.sort((dst, *extra, cost, idx))`` compares costs
    with -0.0 equal to +0.0 — here a sort of an int64 (cost, idx) key
    followed by one stable sort per identity key, last key first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
from asr_decoder_tpu_torch.ops.fetch import fetch_records
from asr_decoder_tpu_torch.ops.gather import (batched_table_gather,
                                              batched_table_gather_many)
from asr_decoder_tpu_torch.ops.traceback import (best_paths, unpack,
                                                 walk_tables)
from asr_decoder_tpu_torch.utils.cuda_graphs import GraphRunner
from asr_decoder_tpu_torch.utils.profiling import scope, span

INF = float("inf")
NO_STATE = -1
BIG_STATE = 2**31 - 1   # sort key for dead candidates
ARC_STAY = -2           # log sentinel: token carried, no arc taken
CLO_BIT = 1 << 30       # dst marker: destination state has ε-closure entries


class GraphArrays(NamedTuple):
    """v2 device graph: padded per-state record tables, field-major (field
    f at lanes [f·L, (f+1)·L)), padding lanes dst = -1, weights as f32 bits.

      * ``em_rec  i32[S, 4·A]`` — emitting arcs: (dst | pdf | weight |
        em-block arc index);
      * ``eps_rec i32[S, 3·Ae]`` — ε arcs (sweeps mode): (dst | weight |
        ε-block arc index);
      * ``clo_rec i32[S, 3·C]`` — ε-closure entries (closure mode):
        (dst | weight | closure-entry index).
    """
    em_rec: torch.Tensor   # i32[S, 4*A]
    eps_rec: torch.Tensor  # i32[S, 3*Ae]  (zero-width in closure mode)
    clo_rec: torch.Tensor  # i32[S, 3*C]   (zero-width in sweeps mode)
    start: int
    final_state: int


class PackedGraph(NamedTuple):
    """v3 device state-record table: row s is state s's record, field-major
    ``[em_dst·A | em_pdf·A | em_w·A | clo_dst·C | clo_w·C]`` (dst padding
    -1, weights as f32 bits) padded to ``lanes`` i32 words."""
    records: torch.Tensor  # i32[S, lanes]
    start: int
    final_state: int


class BeamState(NamedTuple):
    tok_state: torch.Tensor   # i32[B,K]
    tok_cost: torch.Tensor    # f32[B,K]


class FrameLog(NamedTuple):
    """Per-frame search log (same fields as the JAX ``FrameLog``):
    ``prev_slot``/``arc_id`` per relax stage (stage 0 = emit, later stages
    ε) and the post-frame token snapshots the lattice needs.  ``arc_id`` is
    ``ARC_STAY`` for a carried token, else — v3: the flat candidate index;
    v2: a block index (emitting block at stage 0, then closure entries or
    ε-block arcs).  With ``log_snapshots`` off the frame snapshots are
    zero-width."""
    prev_slot: torch.Tensor   # i32[stages,B,K]    (advance: [T,stages,B,K])
    arc_id: torch.Tensor      # i32[stages,B,K]    (advance: [T,stages,B,K])
    tok_state: torch.Tensor   # i32[B,K]           (advance: [T,B,K])
    tok_cost: torch.Tensor    # f32[B,K]           (advance: [T,B,K])


def _pad_block(offset: np.ndarray, count: np.ndarray, lanes: int,
               vals: np.ndarray, fill) -> np.ndarray:
    """CSR field → padded [S, lanes] block (row s = vals[offset_s:+count_s])."""
    lane = np.arange(lanes)
    mask = lane[None, :] < count[:, None]
    idx = np.where(mask, offset[:, None] + lane[None, :], 0)
    if vals.dtype == np.float32:
        vals = vals.view(np.int32)
    out = np.where(mask, vals.astype(np.int32)[idx], fill)
    return out.astype(np.int32)


def _pack_records(offset: np.ndarray, count: np.ndarray, lanes: int,
                  *fields: np.ndarray) -> np.ndarray:
    """CSR → padded field-major record table i32[S, len(fields)·lanes]; the
    first field is dst (padding -1), the others pad with 0."""
    return np.concatenate(
        [_pad_block(offset, count, lanes, f, -1 if i == 0 else 0)
         for i, f in enumerate(fields)], axis=1)


def make_graph_arrays(dev: DeviceFst, ilabel2pdf: np.ndarray, mode: str,
                      device: torch.device | str) -> GraphArrays:
    """The v2 record tables on ``device``; ``ilabel2pdf[i]`` maps arc input
    label i to the AM output row scored for it."""
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    S = dev.num_states
    empty = np.zeros((S, 0), np.int32)
    A = max(dev.max_em_degree, 1)
    em_rec = _pack_records(dev.em_offset, dev.em_count, A, dev.em_dst,
                           ilabel2pdf[dev.em_ilabel], dev.em_weight,
                           np.arange(len(dev.em_dst), dtype=np.int32))
    eps_rec = clo_rec = empty
    if mode == "closure":
        assert dev.clo_offset is not None, "call dev.build_closure() first"
        C = dev.max_closure_size
        if C:
            clo_rec = _pack_records(
                dev.clo_offset, dev.clo_count, C, dev.clo_dst,
                dev.clo_weight, np.arange(len(dev.clo_dst), dtype=np.int32))
    elif len(dev.eps_dst):
        eps_rec = _pack_records(
            dev.eps_offset, dev.eps_count, max(dev.max_eps_degree, 1),
            dev.eps_dst, dev.eps_weight,
            np.arange(len(dev.eps_dst), dtype=np.int32))
    return GraphArrays(*(torch.from_numpy(r).to(device)
                         for r in (em_rec, eps_rec, clo_rec)),
                       start=int(dev.start), final_state=int(dev.final_state))


def packed_lanes(A: int, C: int) -> int:
    """Record width in i32 lanes (32, 64 or 128), or 0 if it does not fit."""
    need = 3 * A + 2 * C
    for lanes in (32, 64, 128):
        if need <= lanes:
            return lanes
    return 0


def make_packed_graph(dev: DeviceFst, ilabel2pdf: np.ndarray,
                      device: torch.device | str) -> tuple[PackedGraph, int]:
    """Build the narrow ``[S, lanes]`` record table on ``device`` (the
    JAX ``make_packed_graph(pack_pages=False)`` layout); returns
    (graph, lanes)."""
    assert dev.clo_offset is not None, "call dev.build_closure() first"
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    A = max(dev.max_em_degree, 1)
    C = dev.max_closure_size
    lanes = packed_lanes(A, C)
    if not lanes:
        raise ValueError(f"state record too wide: A={A} C={C} "
                         f"(3A+2C must be <= 128)")
    em_pdf = ilabel2pdf[dev.em_ilabel]
    em_dst = dev.em_dst.astype(np.int32)
    if C:
        # ε-presence marker: tokens landing on a bit-free state skip the
        # closure fetch and its candidate lanes
        if dev.num_states >= CLO_BIT:
            raise ValueError("graph too large for CLO_BIT (>= 2^30 states)")
        em_dst = np.where((em_dst >= 0) & (dev.clo_count[em_dst] > 0),
                          em_dst | CLO_BIT, em_dst)
    blocks = [
        _pad_block(dev.em_offset, dev.em_count, A, em_dst, -1),
        _pad_block(dev.em_offset, dev.em_count, A, em_pdf, 0),
        _pad_block(dev.em_offset, dev.em_count, A, dev.em_weight, 0),
    ]
    if C:
        blocks += [
            _pad_block(dev.clo_offset, dev.clo_count, C, dev.clo_dst, -1),
            _pad_block(dev.clo_offset, dev.clo_count, C, dev.clo_weight, 0),
        ]
    rec = np.concatenate(blocks, axis=1)
    rec = np.pad(rec, ((0, 0), (0, lanes - rec.shape[1])))
    return (PackedGraph(records=torch.from_numpy(rec).to(device),
                        start=int(dev.start),
                        final_state=int(dev.final_state)),
            lanes)


# ----------------------------------------------------------------------
# ordering helpers (JAX tie semantics, see module docstring)
# ----------------------------------------------------------------------

def _total_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 whose signed order is the IEEE total order of ``x``."""
    b = x.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _smallest(cost: torch.Tensor, k: int):
    """``lax.top_k(-cost, k)`` as (values, i32 indices): ascending total
    order, ties by lowest index."""
    key, idx = torch.sort(_total_key(cost), dim=1, stable=True)
    return (_total_key(key[:, :k]).view(torch.float32),  # key is involutive
            idx[:, :k].to(torch.int32))


def _lexsort(ids, cost, idx):
    """``lax.sort((*ids, cost, idx), num_keys=len(ids) + 2)`` on rows: the
    i32 identity keys ``ids`` first (``ids[0]`` most significant), then
    ``cost`` with -0.0 equal to +0.0, then ``idx``, which is distinct
    within a row (so the order is total).  Returns the sorted
    ``(*ids, cost, idx)``."""
    canon = torch.where(cost == 0, torch.zeros_like(cost), cost)  # -0 ≡ +0
    low = _total_key(canon).long() * 2**32 + idx.long()
    _, order = torch.sort(low, dim=1)
    for key in reversed(ids):
        _, by = torch.sort(torch.gather(key, 1, order), dim=1, stable=True)
        order = torch.gather(order, 1, by)
    return tuple(torch.gather(t, 1, order) for t in (*ids, cost, idx))


def _lane_iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


# ----------------------------------------------------------------------
# v2 (relax_impl=sort) stages
# ----------------------------------------------------------------------

def _relax_and_prune(dst, cost, *, K, beam, min_active, extra_keys=()):
    """Min-merge flat candidates by destination, then prune (the v2
    ``FindOrAddToken`` + ``GetCutoff``, ref online-decoder-base-inl.h:
    89-245): a lexicographic sort by (dst, *extra_keys, cost, candidate
    index); the first candidate of each segment is that destination's best
    (ties by lowest candidate index — the reference's first-writer-wins);
    then the best K by cost, with an adaptive beam that never drops the
    best ``min_active`` — counted after the dedup, unlike v3.

    ``extra_keys``: further i32[B,N] identity lanes (e.g. LM states of a
    pair search) that join dst in the merge key; their pruned [B,K]
    values are returned after the keep mask.

    Returns (state i32[B,K], cost f32[B,K], win i32[B,K] flat candidate
    index, keep bool[B,K], *extras).
    """
    B, N = dst.shape
    dev = dst.device
    sort_dst = torch.where(torch.isfinite(cost), dst, BIG_STATE)
    idx = _lane_iota(N, dev).expand(B, N)
    *ids_s, cost_s, idx_s = _lexsort((sort_dst, *extra_keys), cost, idx)
    sort_dst, extras_s = ids_s[0], ids_s[1:]
    same = sort_dst[:, 1:] == sort_dst[:, :-1]
    for e in extras_s:
        same = same & (e[:, 1:] == e[:, :-1])
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       ~same], dim=1)
    cost_s = torch.where(first & (sort_dst != BIG_STATE), cost_s, INF)
    cost_k, tk = _smallest(cost_s, K)
    state_k, win, *extras_k = batched_table_gather_many(
        (sort_dst, idx_s, *extras_s), tk)
    # adaptive beam: always keep the best min_active slots
    keep = torch.isfinite(cost_k) & ((cost_k <= cost_k[:, :1] + beam)
                                     | (_lane_iota(K, dev) < min_active))
    extras_k = tuple(torch.where(keep, e, 0) for e in extras_k)
    return (torch.where(keep, state_k, NO_STATE),
            torch.where(keep, cost_k, INF),
            torch.where(keep, win, 0), keep, *extras_k)


def _split_fields(rows, fields: int):
    """Field-major record rows [B,K,F·L] → F flat [B, K·L] lane blocks."""
    B, K, FL = rows.shape
    L = FL // fields
    return [rows[:, :, f * L:(f + 1) * L].reshape(B, K * L)
            for f in range(fields)]


def _rows(rec, state, fields: int):
    """Each token's padded record row, split into ``fields`` flat [B, K·L]
    lane blocks; dead slots read row 0 (masked by the caller)."""
    return _split_fields(rec[torch.where(state != NO_STATE, state, 0)],
                         fields)


def _emit_stage(g: GraphArrays, state, cost, ll, *, cfg):
    """ProcessEmitting (ref inl.h:247-352): each beam state's emitting-arc
    row, flat ``[B, K·A]`` candidates scored against ``ll`` f32[B,V],
    relax, prune.  Returns (state, cost, prev slot, emitting-block arc id
    or ARC_STAY)."""
    with scope("search/emit"):
        A = cfg["A"]
        dstN, pdf, wbits, aidN = _rows(g.em_rec, state, 4)
        valid = (state != NO_STATE).repeat_interleave(A, dim=1)
        amask = valid & (dstN >= 0)
        am = batched_table_gather(ll, torch.where(amask, pdf, 0))
        candN = torch.where(amask,
                            cost.repeat_interleave(A, dim=1)
                            + wbits.view(torch.float32)
                            - cfg["acoustic_scale"] * am, INF)
        state, cost, win, keep = _relax_and_prune(
            torch.where(amask, dstN, 0), candN, K=cfg["K"], beam=cfg["beam"],
            min_active=cfg["min_active"])
        prev = torch.where(keep, win // A, 0)
        aid = torch.where(keep, batched_table_gather(aidN, win), ARC_STAY)
        return state, cost, prev, aid


def _table_stage(rec, state, cost, *, K, beam, min_active):
    """One ε relaxation stage over a record table i32[S, 3·L] (closure
    entries or ε arcs): L table candidates per token plus a trailing stay
    candidate per token.  Returns (state, cost, prev, table entry index or
    ARC_STAY)."""
    B = state.shape[0]
    L = rec.shape[1] // 3
    if L == 0:
        # zero-lane table (eps_iters forced > 0 on an ε-free graph): every
        # token stays put
        return (state, cost, _lane_iota(K, state.device).expand(B, K),
                torch.full((B, K), ARC_STAY, dtype=torch.int32,
                           device=state.device))
    N = K * L
    d, wbits, eidxN = _rows(rec, state, 3)
    valid = state != NO_STATE
    emask = valid.repeat_interleave(L, dim=1) & (d >= 0)
    candN = torch.where(emask, cost.repeat_interleave(L, dim=1)
                        + wbits.view(torch.float32), INF)
    dst_all = torch.cat([torch.where(emask, d, 0),
                         torch.where(valid, state, 0)], dim=1)
    cand_all = torch.cat([candN, torch.where(valid, cost, INF)], dim=1)
    state, cost, win, keep = _relax_and_prune(
        dst_all, cand_all, K=K, beam=beam, min_active=min_active)
    is_stay = win >= N
    prev = torch.where(keep, torch.where(is_stay, win - N, win // L), 0)
    aid = torch.where(keep & ~is_stay,
                      batched_table_gather(eidxN, torch.clamp(win, max=N - 1)),
                      ARC_STAY)
    return state, cost, prev, aid


def _eps_stages(g: GraphArrays, state, cost, *, cfg):
    """All ε stages of one frame: one closure relaxation (closure mode) or
    E bounded sweeps (sweeps mode).  Returns (state, cost, (prev, aid)),
    logs [S_eps,B,K]."""
    B, K = state.shape
    kw = dict(K=K, beam=cfg["beam"], min_active=cfg["min_active"])
    if cfg["mode"] == "closure":
        tables = [g.clo_rec] if cfg["C"] > 0 else []
    else:
        tables = [g.eps_rec] * cfg["E"]
    prevs, aids = [], []
    for rec in tables:
        state, cost, prev, aid = _table_stage(rec, state, cost, **kw)
        prevs.append(prev)
        aids.append(aid)
    if not prevs:
        empty = torch.zeros((0, B, K), dtype=torch.int32, device=state.device)
        return state, cost, (empty, empty)
    return state, cost, (torch.stack(prevs), torch.stack(aids))


def _frame_step(g: GraphArrays, state, cost, ll, *, cfg):
    """One v2 frame: the emitting stage, then the ε stage(s); logs [S,B,K]
    (stage 0 = emitting, referencing previous-frame slots)."""
    state, cost, prev0, aid0 = _emit_stage(g, state, cost, ll, cfg=cfg)
    with scope("search/eps"):
        state, cost, (eprev, eaid) = _eps_stages(g, state, cost, cfg=cfg)
    return (state, cost, torch.cat([prev0[None], eprev]),
            torch.cat([aid0[None], eaid]))


# ----------------------------------------------------------------------
# v3 (relax_impl=topk) stages
# ----------------------------------------------------------------------

def _relax_topk(dst, cost, *, K, beam, min_active, F, clo_first=False):
    """Top-k-first min-merge + prune (the v3 ``FindOrAddToken`` +
    ``GetCutoff``, ref online-decoder-base-inl.h:89-245): keep the best K·F
    candidates by cost, dedup by destination with a narrow 3-key sort,
    re-prune to the best K distinct states.

    ``min_active`` is applied at candidate rank before the dedup, as in the
    JAX engine (ROADMAP §3 records the difference from the reference).
    With ``clo_first`` the survivors — always selected by cost — are
    regrouped so CLO_BIT destinations come first, by the bare 0/1 bit (a
    cost-weighted key breaks at beam≈1e9).

    Returns (state i32[B,K], cost f32[B,K], fi i32[B,K] flat candidate
    index (0 where dead), alive bool[B,K], live i32[B]); the output is
    live-prefix, which the next stage's fetch relies on.
    """
    B, N = dst.shape
    dev = dst.device
    KF = min(K * F, N)
    cost_k, fi = _smallest(cost, KF)
    dead = ~torch.isfinite(cost_k)
    dst_k = batched_table_gather(dst, torch.where(dead, 0, fi))
    dst_k = torch.where(dead, BIG_STATE, dst_k)
    # adaptive beam mask at candidate rank (ref GetCutoff)
    best = cost_k[:, :1]
    keep = ~dead & ((cost_k <= best + beam) | (_lane_iota(KF, dev)
                                               < min_active))
    cost_k = torch.where(keep, cost_k, INF)
    dst_k = torch.where(keep, dst_k, BIG_STATE)
    # dedup by destination: first of each dst segment wins
    d_s, c_s, fi_s = _lexsort((dst_k,), cost_k, fi)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       d_s[:, 1:] != d_s[:, :-1]], dim=1)
    c_s = torch.where(first & (d_s != BIG_STATE), c_s, INF)
    if clo_first and KF == K:
        # every candidate survives: group only
        bit_s = torch.where(d_s != BIG_STATE, (d_s >> 30) & 1, 0)
        val = torch.where(torch.isfinite(c_s), bit_s.float(), -INF)
        _, pos = _smallest(-val, K)
    elif clo_first:
        c1, pos1 = _smallest(c_s, K)                      # select by cost
        alive1 = torch.isfinite(c1)
        bit1 = batched_table_gather(
            torch.where(d_s != BIG_STATE, (d_s >> 30) & 1, 0),
            torch.where(alive1, pos1, 0))
        val = torch.where(alive1, bit1.float(), -INF)
        _, pos2 = _smallest(-val, K)                      # group ε-first
        pos = batched_table_gather(pos1, pos2)
    if clo_first:
        # the winners' cost, state and candidate index: one gather
        cost2, state2, fi2 = batched_table_gather_many((c_s, d_s, fi_s), pos)
    else:
        cost2, pos = _smallest(c_s, K)
        state2, fi2 = batched_table_gather_many((d_s, fi_s), pos)
    alive = torch.isfinite(cost2)
    state2 = torch.where(alive, state2, NO_STATE)
    fi2 = torch.where(alive, fi2, 0)
    cost2 = torch.where(alive, cost2, INF)
    live = alive.sum(dim=1, dtype=torch.int32)
    return state2, cost2, fi2, alive, live


def _emit_stage_v3(pg: PackedGraph, state, cost, ll, *, cfg):
    """ProcessEmitting: one live-adaptive fetch of each active state's
    record, flat [B, K·A] candidates scored against ``ll`` f32[B,V], relax."""
    with scope("search/emit3"):
        K, A = cfg["K"], cfg["A"]
        B = state.shape[0]
        N = K * A
        valid = state != NO_STATE
        rows = fetch_records(pg.records, state,
                             valid.sum(dim=1, dtype=torch.int32))
        dstN = rows[:, :, 0:A].reshape(B, N)
        pdfN = rows[:, :, A:2 * A].reshape(B, N)
        wN = rows[:, :, 2 * A:3 * A].reshape(B, N).view(torch.float32)
        # dead slots' rows were never fetched: mask by the slot, not the row
        amask = valid.repeat_interleave(A, dim=1) & (dstN >= 0)
        am = batched_table_gather(ll, torch.where(amask, pdfN, 0))
        candN = torch.where(amask,
                            cost.repeat_interleave(A, dim=1) + wN
                            - cfg["acoustic_scale"] * am, INF)
        dstN = torch.where(amask, dstN, BIG_STATE)
        state2, cost2, fi, alive, _ = _relax_topk(
            dstN, candN, K=K, beam=cfg["beam"],
            min_active=cfg["min_active"], F=cfg["F"], clo_first=cfg["C"] > 0)
        prev = torch.where(alive, fi // A, 0)
        aid = torch.where(alive, fi, ARC_STAY)
        return state2, cost2, prev, aid


def _clo_stage_v3(pg: PackedGraph, state, cost, *, cfg):
    """ProcessNonemitting: fetch the records of the tokens whose state
    carries the CLO_BIT (the emit relax put them at the beam front, so the
    fetch's live count is just those), relax their ε-closure entries plus a
    stay candidate for every live token."""
    with scope("search/eps3"):
        K, A, C = cfg["K"], cfg["A"], cfg["C"]
        B = state.shape[0]
        N = K * C
        valid = state != NO_STATE
        has_clo = valid & (((state >> 30) & 1) != 0)
        clean = torch.where(valid, state & ~CLO_BIT, state)
        rows = fetch_records(pg.records, clean,
                             has_clo.sum(dim=1, dtype=torch.int32))
        dstN = rows[:, :, 3 * A:3 * A + C].reshape(B, N)
        wN = rows[:, :, 3 * A + C:3 * A + 2 * C].reshape(B, N).view(
            torch.float32)
        # bit-free tokens' rows were never fetched: mask by the marker
        emask = has_clo.repeat_interleave(C, dim=1) & (dstN >= 0)
        candN = torch.where(emask, cost.repeat_interleave(C, dim=1) + wN, INF)
        dstN = torch.where(emask, dstN, BIG_STATE)
        dst_all = torch.cat([dstN, torch.where(valid, clean, BIG_STATE)],
                            dim=1)
        cand_all = torch.cat([candN, torch.where(valid, cost, INF)], dim=1)
        state2, cost2, fi, alive, _ = _relax_topk(
            dst_all, cand_all, K=K, beam=cfg["beam"],
            min_active=cfg["min_active"], F=cfg["F"])
        is_stay = fi >= N
        prev = torch.where(alive, torch.where(is_stay, fi - N, fi // C), 0)
        aid = torch.where(alive & ~is_stay, fi, ARC_STAY)
        return state2, cost2, prev, aid


def _frame_step_v3(pg: PackedGraph, state, cost, ll, *, cfg):
    state, cost, prev0, aid0 = _emit_stage_v3(pg, state, cost, ll, cfg=cfg)
    if cfg["C"] > 0:
        state, cost, prev1, aid1 = _clo_stage_v3(pg, state, cost, cfg=cfg)
        return state, cost, torch.stack([prev0, prev1]), \
            torch.stack([aid0, aid1])
    return state, cost, prev0[None], aid0[None]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


FRAME_WINDOW = 64   # frames the frame loop's static buffers hold


class _FrameBuffers(NamedTuple):
    """The static buffers of one search's frame loop: a window of
    ``FRAME_WINDOW`` frames' loglikes [W,B,V] and row masks [W,B] in;
    ``pos`` i64[1], the window frame that the next frame reads and logs;
    the carry lanes [B,K], updated in place; the window's logs out (prev
    and aid [W,S,B,K], flags [W,B], snapshots [W,B,K] or [W,B,0])."""
    lls: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    carry: tuple
    prevs: torch.Tensor
    aids: torch.Tensor
    flags: tuple
    snaps: tuple
    slot: torch.Tensor      # i32[1,K], a masked row's prev


def _live_frame(step, buf: _FrameBuffers) -> None:
    """One live frame on the frame loop's buffers: the body that the card
    captures once and replays (``utils/cuda_graphs.py``)."""
    t = buf.pos
    m = buf.mask.index_select(0, t)[0][:, None]            # [B,1]
    new, prev, aid, *fl = step(buf.carry, buf.lls.index_select(0, t)[0])
    for c, n in zip(buf.carry, new):
        c.copy_(torch.where(m, n, c))
    buf.prevs.index_copy_(0, t, torch.where(m[None], prev, buf.slot)[None])
    buf.aids.index_copy_(0, t, torch.where(m[None], aid, ARC_STAY)[None])
    for log, f in zip(buf.flags, fl):
        log.index_copy_(0, t, (f & m[:, 0])[None])
    for snap, c in zip(buf.snaps, buf.carry):
        if snap.shape[2]:
            snap.index_copy_(0, t, c[None])
    buf.pos.add_(1)


def _dead_frame(buf: _FrameBuffers, i: int) -> None:
    """Window frame ``i`` is masked in every row: the frame step is
    skipped, every row keeps its carry and logs its own slot and
    ARC_STAY."""
    buf.prevs[i] = buf.slot
    buf.aids[i] = ARC_STAY
    for log in buf.flags:
        log[i] = False
    for snap, c in zip(buf.snaps, buf.carry):
        if snap.shape[2]:
            snap[i] = c
    buf.pos.add_(1)


def _frame_loop(graphs: dict, step, carry: tuple, V: int, stages: int,
                flags: int, snap_k: int, device) -> GraphRunner:
    """The search's frame runner for this static key, made at first use:
    the counterpart of the JAX jit cache, keyed by the shapes and dtypes
    (the search's static config is fixed for the search)."""
    B, K = carry[0].shape
    key = (B, K, V, stages, flags, snap_k, str(device),
           tuple(c.dtype for c in carry))
    run = graphs.get(key)
    if run is None:
        W = FRAME_WINDOW
        buf = _FrameBuffers(
            lls=torch.empty((W, B, V), dtype=torch.float32, device=device),
            mask=torch.empty((W, B), dtype=torch.bool, device=device),
            pos=torch.zeros((1,), dtype=torch.int64, device=device),
            carry=tuple(torch.empty_like(c) for c in carry),
            prevs=torch.empty((W, stages, B, K), dtype=torch.int32,
                              device=device),
            aids=torch.empty((W, stages, B, K), dtype=torch.int32,
                             device=device),
            flags=tuple(torch.empty((W, B), dtype=torch.bool, device=device)
                        for _ in range(flags)),
            snaps=tuple(torch.empty((W, B, snap_k), dtype=c.dtype,
                                    device=device) for c in carry),
            slot=_lane_iota(K, device))
        run = graphs[key] = GraphRunner(functools.partial(_live_frame, step),
                                        buf, device)
    return run


def run_frames(step, carry: tuple, loglikes, frame_mask, *, device,
               stages: int, snapshots: bool, pdf_max: int, graphs: dict,
               flags: int = 0):
    """The frame loop every search shares (the JAX ``lax.scan`` over a
    chunk): ``step(carry, ll f32[B,V])`` returns ``(carry, prev, aid,
    *flags)`` — ``carry`` a tuple of [B,K] beam lanes, ``prev``/``aid``
    i32[stages,B,K], each flag bool[B].  A row whose frame is masked keeps
    its carry and logs prev = its own slot, aid = ARC_STAY, flags False.

    Each live frame is one call of the search's frame runner from
    ``graphs`` (one replay of a captured CUDA graph on the card): the
    runner reads its frame from a window of ``FRAME_WINDOW`` frames in
    static buffers and writes the frame's logs there, so the host copies
    a window in and its logs out, and copies nothing a frame.

    ``loglikes`` f32[B,T,V] and ``frame_mask`` bool[B,T] (None = all
    frames), host or device.  Returns ``(carry, prevs [T,S,B,K], aids,
    flags [T,B] each, snapshots [T,B,K] per carry lane)``, none of them
    sharing memory with the runner's buffers; the snapshots are [T,B,0]
    with ``snapshots`` off."""
    lls = torch.as_tensor(loglikes, dtype=torch.float32, device=device)
    B, T, V = lls.shape
    if pdf_max >= V:
        raise ValueError(f"graph scores pdf {pdf_max} but loglikes have "
                         f"{V} columns")
    if frame_mask is None:
        mask_host = np.ones((B, T), bool)
    else:
        mask_host = _np(frame_mask).astype(bool)
    mask = torch.from_numpy(mask_host).to(device)
    # whole-batch masked frames skip the frame step (the reference's
    # SkipBlockFrame fast path, ref nnet-nnet.h:265-275); decided on the
    # host once per chunk, so the frame loop never syncs
    live_frames = mask_host.any(axis=0)
    K = carry[0].shape[1]
    snap_k = K if snapshots else 0
    prevs = torch.empty((T, stages, B, K), dtype=torch.int32, device=device)
    aids = torch.empty_like(prevs)
    flag_logs = [torch.empty((T, B), dtype=torch.bool, device=device)
                 for _ in range(flags)]
    snaps = [torch.empty((T, B, snap_k), dtype=c.dtype, device=device)
             for c in carry]
    run = _frame_loop(graphs, step, carry, V, stages, flags, snap_k, device)
    buf = run.buffers
    with run.lock:
        for c, src in zip(buf.carry, carry):
            c.copy_(src)
        for w0 in range(0, T, FRAME_WINDOW):
            n = min(FRAME_WINDOW, T - w0)
            win = slice(w0, w0 + n)
            buf.lls[:n] = lls[:, win].transpose(0, 1)
            buf.mask[:n] = mask[:, win].t()
            buf.pos.zero_()
            for i in range(n):
                if live_frames[w0 + i]:
                    run()
                else:
                    _dead_frame(buf, i)
            prevs[win] = buf.prevs[:n]
            aids[win] = buf.aids[:n]
            for log, f in zip(flag_logs, buf.flags):
                log[win] = f[:n]
            if snap_k:
                for snap, s in zip(snaps, buf.snaps):
                    snap[win] = s[:n]
        carry = tuple(c.clone() for c in buf.carry)
    return carry, prevs, aids, flag_logs, snaps


def _select_engine(dev: DeviceFst, cfg: DecoderConfig
                   ) -> tuple[str, int, str]:
    """The JAX ``TpuBeamSearch`` rules for the ε mode and the relax engine
    (``asr_decoder_tpu/ops/beamsearch.py:769-803``); returns (mode,
    eps_iters, relax_impl).  Builds the closure table where it is used."""
    mode = cfg.eps_mode
    if mode not in ("auto", "closure", "sweeps"):
        raise ValueError(f"unknown eps_mode {mode!r}")
    if mode in ("auto", "closure"):
        try:
            dev.build_closure()
            mode = ("sweeps" if mode == "auto"
                    and dev.max_closure_size > cfg.closure_lanes_max
                    else "closure")
        except ValueError:
            if mode == "closure":
                raise
            mode = "sweeps"
    eps_iters = 0
    if mode == "sweeps":
        eps_iters = cfg.eps_iters or dev.eps_depth
        if eps_iters < 0:
            raise ValueError("epsilon cycle: sweeps mode unusable (use "
                             "eps_mode=closure)")
    relax = cfg.relax_impl
    A = max(dev.max_em_degree, 1)
    C = dev.max_closure_size if mode == "closure" else 0
    v3_ok = mode == "closure" and packed_lanes(A, C) > 0 and cfg.log_snapshots
    if relax == "auto":
        relax = "topk" if v3_ok else "sort"
    elif relax == "topk" and not v3_ok:
        raise ValueError("relax_impl=topk needs eps_mode=closure, a "
                         "record that fits (3A+2C<=128) and log_snapshots")
    elif relax not in ("topk", "sort"):
        raise ValueError(f"unknown relax_impl {relax!r}")
    return mode, eps_iters, relax


class TorchBeamSearch:
    """Batched beam-search decoder over a fixed graph on one device.

    The surface of the JAX ``TpuBeamSearch`` (ref ``DecoderItf``,
    src/my-decoder/decoder-itf.h:10-25): ``init_state`` ≡ InitDecoding,
    ``advance`` ≡ AdvanceDecoding over a chunk of frames,
    ``traceback`` ≡ GetBestPath, plus ``token_sets``/``get_lattices``.
    ``mode`` (closure|sweeps) and ``relax_impl`` (topk = v3, sort = v2)
    follow the JAX class's ``auto`` rules.
    """

    def __init__(self, dev: DeviceFst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None, *,
                 device: torch.device | str):
        self.config = config or DecoderConfig()
        cfg = self.config
        self._graphs: dict = {}   # frame runners by static key (run_frames)
        self._walk_tables: dict = {}  # device traceback's tables by device
        cfg.check()
        if cfg.gather_impl or cfg.fetch_impl:
            raise ValueError(
                "gather_impl/fetch_impl name TPU paths; in the PyTorch port "
                "the tensor's device picks the kernel — leave them empty")
        if dev.max_em_degree > cfg.arc_lanes:
            raise ValueError("graph not degree-bounded: rebuild DeviceFst "
                             "with arc_lanes")
        self.mode, eps_iters, self.relax_impl = _select_engine(dev, cfg)
        self.dev = dev
        self.device = torch.device(device)
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
        self._pdf_max = int(self._ilabel2pdf[dev.em_ilabel].max()) \
            if len(dev.em_ilabel) else -1
        self.A = A = max(dev.max_em_degree, 1)
        self.C = C = dev.max_closure_size if self.mode == "closure" else 0
        self.beam_width = K = min(cfg.beam_width, cfg.max_active)
        common = dict(K=K, A=A, C=C, beam=float(cfg.beam),
                      min_active=int(cfg.min_active),
                      acoustic_scale=float(cfg.acoustic_scale))
        if self.relax_impl == "topk":
            self.graph = None
            self.pgraph, self.lanes = make_packed_graph(
                dev, self._ilabel2pdf, self.device)
            self._cfg = dict(common, F=int(cfg.topk_overfetch))
            self.num_stages = 1 + int(C > 0)
        else:
            self.pgraph, self.lanes = None, None
            self.graph = make_graph_arrays(dev, self._ilabel2pdf, self.mode,
                                           self.device)
            self._cfg = dict(common, E=eps_iters, mode=self.mode)
            self.num_stages = 1 + (eps_iters if self.mode == "sweeps"
                                   else int(C > 0))

    # -- InitDecoding ------------------------------------------------------
    @torch.inference_mode()
    def init_state(self, batch: int) -> tuple[BeamState, FrameLog]:
        K = self.beam_width
        state = torch.full((batch, K), NO_STATE, dtype=torch.int32,
                           device=self.device)
        cost = torch.full((batch, K), INF, dtype=torch.float32,
                          device=self.device)
        cost[:, 0] = 0.0
        if self.relax_impl == "sort":
            state[:, 0] = self.graph.start
            state, cost, (prev, aid) = _eps_stages(self.graph, state, cost,
                                                   cfg=self._cfg)
        elif self.C > 0:
            # unconditional CLO_BIT on the start token: the closure stage
            # fetches its record (harmless if start has no ε)
            state[:, 0] = self.pgraph.start | CLO_BIT
            state, cost, prev, aid = _clo_stage_v3(self.pgraph, state, cost,
                                                   cfg=self._cfg)
            prev, aid = prev[None], aid[None]
        else:
            state[:, 0] = self.pgraph.start
            prev = torch.zeros((0, batch, K), dtype=torch.int32,
                               device=self.device)
            aid = torch.zeros_like(prev)
        return BeamState(state, cost), FrameLog(prev, aid, state, cost)

    # -- AdvanceDecoding over a chunk of frames ----------------------------
    @torch.inference_mode()
    def advance(self, state: BeamState, loglikes, frame_mask=None
                ) -> tuple[BeamState, FrameLog]:
        """loglikes f32[B,T,V]; frame_mask bool[B,T] (False = padding),
        host or device.  Returns the new beam and the chunk's logs
        (prev/aid [T,S,B,K], snapshots [T,B,K], or [T,B,0] with
        ``log_snapshots`` off) on the search's device."""
        # the cached frame runner keeps the step: it holds the tables and
        # the config, not the search
        frame = (functools.partial(_frame_step_v3, self.pgraph, cfg=self._cfg)
                 if self.relax_impl == "topk" else
                 functools.partial(_frame_step, self.graph, cfg=self._cfg))

        def step(carry, ll):
            ns, nc, prev, aid = frame(*carry, ll)
            return (ns, nc), prev, aid

        carry, prevs, aids, _, snaps = run_frames(
            step, tuple(state), loglikes, frame_mask, device=self.device,
            stages=self.num_stages, snapshots=self.config.log_snapshots,
            pdf_max=self._pdf_max, graphs=self._graphs)
        return BeamState(*carry), FrameLog(prevs, aids, *snaps)

    def decode(self, loglikes, frame_mask=None):
        """Full utterance decode: init + advance.  Returns
        (final BeamState, init FrameLog, frame FrameLogs)."""
        state, init_log = self.init_state(len(loglikes))
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    # -- host-side raw lattice (ref GetRawLattice inl.h:869-977) -----------
    def token_sets(self, init_log: FrameLog, logs: FrameLog, b: int,
                   num_frames: int | None = None) -> list[dict[int, float]]:
        """Per-frame surviving-token sets {orig_state: cost} for utterance
        ``b``, folding split continuation states back to their source."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        orig = self.dev.orig_state
        tok_state, tok_cost = _np(logs.tok_state), _np(logs.tok_cost)
        if num_frames is None:
            num_frames = tok_state.shape[0]
        snaps = [(_np(init_log.tok_state)[b], _np(init_log.tok_cost)[b])]
        snaps += [(tok_state[t, b], tok_cost[t, b])
                  for t in range(num_frames)]
        out = []
        for st, co in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict[int, float] = {}
            for s, c in zip(orig[st[ok]], co[ok]):
                s = int(s)
                c = float(c)
                if c < toks.get(s, np.inf):
                    toks[s] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log: FrameLog, logs: FrameLog,
                     loglikes, fst, frame_mask=None):
        """Pruned raw lattices for every utterance from the token snapshots
        (``decoder/raw_lattice.py``); ``fst`` is the source StdFst."""
        from asr_decoder_tpu_torch.decoder.raw_lattice import \
            lattice_from_token_sets
        loglikes = _np(loglikes)
        B, T = loglikes.shape[:2]
        lens = (_np(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets(
                    fst, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    # -- host-side best path (ref GetBestPath / TraceBackBestPath,
    #    online-decoder-base-inl.h:1072-1161) ------------------------------
    def traceback(self, state: BeamState, init_log: FrameLog, logs,
                  fst_arcs=None) -> list[dict]:
        """Per-utterance dicts with arc ids, words, ilabels, cost.

        ``logs``: one FrameLog or a list of per-chunk FrameLogs (the host
        walks them in reverse without concatenation).  ``fst_arcs``: the
        source StdFst for olabel/ilabel lookup; if None only arc ids and
        cost are returned.  The super-final token is preferred, else the
        best live one.

        Where the v3 logs lie on a CUDA device, the walk runs there
        (``ops/traceback.py``, chunks concatenated on the device first) and
        only the paths come back; logs on the host (the server's and the
        sessions' per-chunk copies) and the v2 engine's are walked on the
        host.  Both give equal dicts.  The spans ``traceback/copy`` (logs
        on the card: the walk and the copy of its output; on the host: the
        state, logs and snapshots to the host) and ``traceback/walk`` (on
        the card: the paths' reversal and label lookups; on the host: the
        walk) time its two parts."""
        chunks = logs if isinstance(logs, list) else [logs]
        if self.relax_impl == "topk" and chunks and all(
                isinstance(c.prev_slot, torch.Tensor) and c.prev_slot.is_cuda
                for c in chunks):
            return self._traceback_device(state, init_log, chunks, fst_arcs)
        with span("traceback/copy"):
            tok_state = _np(state.tok_state)
            tok_cost = _np(state.tok_cost)
            walk = (self._walk_v3 if self.relax_impl == "topk"
                    else self._walk_v2)(chunks, init_log)
        final_id = int(self.dev.final_state)
        results = []
        with span("traceback/walk"):
            for b in range(tok_state.shape[0]):
                finals = np.where(tok_state[b] == final_id)[0]
                if len(finals):
                    slot = int(finals[np.argmin(tok_cost[b][finals])])
                else:
                    slot = int(np.argmin(tok_cost[b]))
                arc_ids = walk(b, slot)[::-1]
                res = dict(arc_ids=arc_ids, cost=float(tok_cost[b, slot]),
                           reached_final=bool(len(finals)))
                if fst_arcs is not None:
                    ol = fst_arcs.arc_olabel[arc_ids]
                    il = fst_arcs.arc_ilabel[arc_ids]
                    res["words"] = [int(x) for x in ol[ol != 0]]
                    res["ilabels"] = [int(x) for x in il[il != 0]]
                results.append(res)
        return results

    @torch.inference_mode()
    def _traceback_device(self, state: BeamState, init_log: FrameLog,
                          chunks: list, fst_arcs) -> list[dict]:
        """The v3 traceback over logs on a CUDA device: one launch of the
        walk kernel for the batch, one copy of its paths to pinned host
        memory, then per row the reversal and label lookups."""
        device = chunks[0].prev_slot.device
        with span("traceback/copy"):
            tables = self._walk_tables.get(device)
            if tables is None:
                tables = self._walk_tables[device] = walk_tables(
                    self.dev, self.A, self.C, device)
            prev, aid, snap = (
                torch.cat(x) if len(x) > 1 else x[0]
                for x in zip(*((c.prev_slot, c.arc_id, c.tok_state)
                               for c in chunks)))
            on = functools.partial(torch.as_tensor, device=device)
            out = best_paths(tables, on(state.tok_state), on(state.tok_cost),
                             prev, aid, snap, on(init_log.prev_slot),
                             on(init_log.arc_id), on(init_log.tok_state))
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
        results = []
        with span("traceback/walk"):
            for arcs, cost, final in unpack(host.numpy()):
                res = dict(arc_ids=arcs.tolist(), cost=cost,
                           reached_final=final)
                if fst_arcs is not None:
                    ol = fst_arcs.arc_olabel[arcs]
                    il = fst_arcs.arc_ilabel[arcs]
                    res["words"] = ol[ol != 0].tolist()
                    res["ilabels"] = il[il != 0].tolist()
                results.append(res)
        return results

    def _decode_stage_arcs(self, stage: int, a: int) -> list[int]:
        """v2: a logged per-stage arc id → original StdFst arc ids,
        backward-ordered."""
        if a < 0:
            return []
        if stage == 0:                       # emitting block index
            return [int(self.dev.em_arcid[a])]
        if self.mode == "closure":           # closure entry index
            return [int(x) for x in self.dev.clo_paths(a)]
        aid = int(self.dev.eps_arcid[a])     # ε block index
        return [aid] if aid >= 0 else []     # skip split-chain links

    def _walk_v2(self, chunks, init_log):
        """v2 backward walk: the logs hold (prev slot, block arc id) per
        stage, so arc ids come straight from the DeviceFst tables."""
        chunks = [(_np(c.prev_slot), _np(c.arc_id)) for c in chunks]
        iprev, iaid = _np(init_log.prev_slot), _np(init_log.arc_id)

        def walk(b: int, slot: int) -> list[int]:
            arcs_rev: list[int] = []
            for prevs, aids in reversed(chunks):
                for t in range(prevs.shape[0] - 1, -1, -1):
                    for s in range(prevs.shape[1] - 1, -1, -1):
                        arcs_rev.extend(self._decode_stage_arcs(
                            s, int(aids[t, s, b, slot])))
                        slot = int(prevs[t, s, b, slot])
            for s in range(iprev.shape[0] - 1, -1, -1):
                arcs_rev.extend(self._decode_stage_arcs(
                    s + 1, int(iaid[s, b, slot])))
                slot = int(iprev[s, b, slot])
            return arcs_rev
        return walk

    def _walk_v3(self, chunks, init_log):
        """v3 backward walk: the logs hold only (prev slot, flat candidate
        index); arc ids are re-derived as ``em_arcid[em_offset[prev_state]
        + lane]`` (closure entries as ``clo_offset[post_emit_state] +
        lane``) from the token snapshots."""
        dev = self.dev
        A, C = self.A, self.C
        chunks = [(_np(c.prev_slot), _np(c.arc_id), _np(c.tok_state))
                  for c in chunks]
        init_snap = _np(init_log.tok_state)
        iprev, iaid = _np(init_log.prev_slot), _np(init_log.arc_id)

        def walk(b: int, slot: int) -> list[int]:
            arcs_rev: list[int] = []
            for ci in range(len(chunks) - 1, -1, -1):
                prevs, aids, snaps = chunks[ci]
                for t in range(prevs.shape[0] - 1, -1, -1):
                    if t > 0:
                        prior = snaps[t - 1]
                    elif ci > 0:
                        prior = chunks[ci - 1][2][-1]
                    else:
                        prior = init_snap
                    if C > 0:
                        fi1 = int(aids[t, 1, b, slot])
                        slot = int(prevs[t, 1, b, slot])
                        if fi1 >= 0:
                            # ε-path arcs follow the emit arc on the forward
                            # path, so they come first backward; clo_paths
                            # rows are already backward-ordered
                            fi = int(aids[t, 0, b, slot])
                            assert fi >= 0, "closure entry above a stay slot"
                            ps = int(prior[b, fi // A])
                            s_emit = int(dev.em_dst[int(dev.em_offset[ps])
                                                    + fi % A])
                            entry = int(dev.clo_offset[s_emit]) + fi1 % C
                            arcs_rev.extend(
                                int(x) for x in dev.clo_paths(entry))
                    fi = int(aids[t, 0, b, slot])
                    p = int(prevs[t, 0, b, slot])
                    if fi >= 0:
                        ps = int(prior[b, fi // A])
                        ai = int(dev.em_offset[ps]) + fi % A
                        arcs_rev.append(int(dev.em_arcid[ai]))
                        p = fi // A
                    slot = p
            # init closure stage: pre-closure beam = [start] at slot 0
            if iprev.shape[0]:
                fi1 = int(iaid[0, b, slot])
                slot = int(iprev[0, b, slot])
                if fi1 >= 0:
                    entry = int(dev.clo_offset[int(dev.start)]) + fi1 % C
                    arcs_rev.extend(int(x) for x in dev.clo_paths(entry))
            return arcs_rev
        return walk
