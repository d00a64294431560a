"""Vectorized synthetic decode-graph generator (benchmarks + tests).

Generates HCLG-shaped WFSTs: mostly-emitting arcs with self-loop-like
structure, a bounded out-degree, an acyclic ε-subgraph (forward-only ε arcs),
sparse word olabels, and a super-final state — matching the structural
statistics the search kernel cares about (degree distribution, ε depth) at
arbitrary scale without shipping real model fixtures.
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu_torch.fst.fst import StdFst


def random_hclg(rng: np.random.Generator, num_states: int = 50_000,
                num_ilabels: int = 2048, num_words: int = 5000,
                min_degree: int = 2, max_degree: int = 8,
                eps_frac: float = 0.08,
                self_loop_frac: float = 0.4) -> StdFst:
    """Random decode graph with HCLG-like arc statistics.

    Per state: ``min_degree..max_degree`` arcs; ~``self_loop_frac`` of
    emitting arcs are self-loops (HMM self-transitions); ~``eps_frac`` are
    ε-arcs that only go forward (acyclic ε); one guaranteed forward arc per
    state keeps the graph connected.
    """
    deg = rng.integers(min_degree, max_degree + 1, num_states)
    total = int(deg.sum())
    src = np.repeat(np.arange(num_states, dtype=np.int64), deg)
    lane = np.concatenate([np.arange(d) for d in deg]) if num_states < 1000 \
        else _lane_index(deg)

    dst = rng.integers(0, num_states, total).astype(np.int64)
    # guaranteed chain arc on lane 0
    chain = np.minimum(src + 1, num_states - 1)
    dst = np.where(lane == 0, chain, dst)
    # self loops on a fraction of lanes > 0
    is_self = (lane > 0) & (rng.random(total) < self_loop_frac)
    dst = np.where(is_self, src, dst)

    ilabel = rng.integers(1, num_ilabels + 1, total).astype(np.int64)
    # epsilon arcs: forward-only (dst > src) to keep the eps graph acyclic
    # epsilon arcs ride the chain arc (dst = src+1) from states whose id
    # mod 8 < 3, which bounds eps-chain length at 3 (+1 for the super-final
    # rewrite) — matching real HCLG's shallow eps depth
    can_eps = (lane == 0) & (src % 8 < 3) & (dst > src)
    p_eps = min(1.0, eps_frac / max(float(can_eps.mean()), 1e-9))
    is_eps = can_eps & (rng.random(total) < p_eps)
    ilabel = np.where(is_eps, 0, ilabel)

    olabel = np.where(rng.random(total) < 0.1,
                      rng.integers(1, num_words + 1, total), 0)
    weight = rng.random(total).astype(np.float32) * 4.0

    finals = {num_states - 1: 0.0,
              int(num_states * 0.75): float(rng.random())}
    return StdFst.from_final_weights(
        num_states, 0, src, ilabel.astype(np.int32),
        olabel.astype(np.int32), weight, dst.astype(np.int32), finals)


def _lane_index(deg: np.ndarray) -> np.ndarray:
    """Vectorized per-segment arange: [0..deg0), [0..deg1), ..."""
    total = int(deg.sum())
    ends = np.cumsum(deg)
    starts = ends - deg
    idx = np.arange(total)
    return idx - np.repeat(starts, deg)
