"""N-best extraction from lattices.

Capability parity with the reference's ``NShortestPath`` /
``ConvertNbestToVector`` (ref: src/newfst/lattice-to-nbest.cc:15-147,
lattice-to-nbest.h:13): reverse-Viterbi backward scores, then A*-ordered
forward path expansion.  Run on a determinized lattice for *distinct word
sequences* (that is how the reference pipelines it,
ref: kaldi-online-nnet3-my-decoder.cc GetNbest).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

from asr_decoder_tpu_torch.fst.lattice import EPSILON, Lattice, LatticeArc
from asr_decoder_tpu_torch.fst.semiring import INF, LatticeWeight


@dataclass
class NbestPath:
    words: list[int]
    ilabels: list[int]
    graph_cost: float
    am_cost: float
    arcs: tuple = ()          # the original lattice arcs along the path
    final_weight: object = None   # LatticeWeight of the path's final state

    @property
    def cost(self) -> float:
        return self.graph_cost + self.am_cost


def backward_scores(lat: Lattice) -> list[float]:
    """Best cost-to-final per state (the reference's reverse Viterbi,
    lattice-to-nbest.cc:20-45)."""
    order = lat.topsort_order()
    if order is None:
        raise ValueError("lattice has a cycle")
    beta = [INF] * lat.num_states
    for s in lat.final_states():
        beta[s] = lat.final(s).value
    for s in reversed(order):
        for a in lat.arcs(s):
            c = a.weight.value + beta[a.dst]
            if c < beta[s]:
                beta[s] = c
    return beta


def nshortest(lat: Lattice, n: int, *,
              unique_words: bool = True) -> list[NbestPath]:
    """A* n-shortest-path enumeration (exact: the heuristic beta is the true
    remaining cost, so paths pop in global cost order)."""
    if lat.start < 0 or lat.num_states == 0 or n <= 0:
        return []
    beta = backward_scores(lat)
    if beta[lat.start] == INF:
        return []
    # heap entries: (f, seq#, state, path list of arcs)
    heap: list[tuple[float, int, int, tuple]] = []
    cnt = 0
    heapq.heappush(heap, (beta[lat.start], cnt, lat.start, ()))
    results: list[NbestPath] = []
    seen_words: set[tuple] = set()
    # cap on pops to guard pathological lattices
    budget = max(10_000, 1000 * n)
    while heap and len(results) < n and budget > 0:
        budget -= 1
        f, _, s, path = heapq.heappop(heap)
        fw = lat.final(s)
        if not fw.is_zero():
            words = tuple(a.olabel for a in path if a.olabel != EPSILON)
            if not unique_words or words not in seen_words:
                seen_words.add(words)
                results.append(NbestPath(
                    words=list(words),
                    ilabels=[a.ilabel for a in path if a.ilabel != EPSILON],
                    graph_cost=sum(a.weight.value1 for a in path)
                    + fw.value1,
                    am_cost=sum(a.weight.value2 for a in path) + fw.value2,
                    arcs=path, final_weight=fw))
        g = f - beta[s]
        for a in lat.arcs(s):
            nb = beta[a.dst]
            if nb == INF:
                continue
            cnt += 1
            heapq.heappush(heap, (g + a.weight.value + nb, cnt, a.dst,
                                  path + (a,)))
    return results


def nbest_to_lattices(paths: list[NbestPath]) -> list[Lattice]:
    """Each path as a linear lattice preserving the original arc alignment
    (ref ConvertNbestToVector, lattice-to-nbest.cc:147)."""
    out = []
    for p in paths:
        lat = Lattice()
        s = lat.add_state()
        lat.set_start(s)
        for a in p.arcs:
            nxt = lat.add_state()
            lat.add_arc(s, LatticeArc(a.ilabel, a.olabel, a.weight, nxt))
            s = nxt
        lat.set_final(s, p.final_weight if p.final_weight is not None
                      else LatticeWeight.one())
        out.append(lat)
    return out
