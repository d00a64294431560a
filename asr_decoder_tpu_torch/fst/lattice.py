"""Mutable lattice FST + core lattice algorithms.

Capability parity with the reference's mutable ``Lattice``
(ref: src/newfst/lattice-fst.h:18-346) and its algorithm suite:
shortest path / to-vector (ref: src/newfst/lattice-functions.cc:12-227),
topological sort (ref: src/newfst/topsort.cc), connect/trim
(ref: src/newfst/connect-fst.cc), invert (ref: src/newfst/invert.h),
rm-input (ref: lattice-functions.cc:124), super-final
(ref: lattice-functions.cc:163).

Arc convention (as in the reference): ilabel = transition-id (or pdf+1 for
CTC), olabel = word-id, weight = (graph_cost, acoustic_cost).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from asr_decoder_tpu_torch.fst.semiring import INF, LatticeWeight, times

EPSILON = 0
NO_STATE = -1


@dataclass
class LatticeArc:
    ilabel: int
    olabel: int
    weight: LatticeWeight
    dst: int


class Lattice:
    """Vector-of-states lattice with LatticeWeight arcs and final weights."""

    def __init__(self):
        self._arcs: list[list[LatticeArc]] = []
        self._finals: dict[int, LatticeWeight] = {}
        self.start: int = NO_STATE

    # -- mutation (ref: lattice-fst.h AddState/AddArc/SetFinal) ------------
    def add_state(self) -> int:
        self._arcs.append([])
        return len(self._arcs) - 1

    def add_arc(self, s: int, arc: LatticeArc) -> None:
        self._arcs[s].append(arc)

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, w: LatticeWeight = LatticeWeight.one()) -> None:
        if w.is_zero():
            self._finals.pop(s, None)
        else:
            self._finals[s] = w

    # -- accessors ---------------------------------------------------------
    @property
    def num_states(self) -> int:
        return len(self._arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self._arcs)

    def arcs(self, s: int) -> list[LatticeArc]:
        return self._arcs[s]

    def final(self, s: int) -> LatticeWeight:
        return self._finals.get(s, LatticeWeight.zero())

    def is_final(self, s: int) -> bool:
        return s in self._finals

    def final_states(self) -> list[int]:
        return sorted(self._finals)

    # -- structural ops ----------------------------------------------------
    def delete_states(self, dead: set[int]) -> None:
        """Remove states in ``dead``, renumbering the rest
        (ref: lattice-fst.h DeleteStates)."""
        if not dead:
            return
        remap = {}
        nxt = 0
        for s in range(self.num_states):
            if s not in dead:
                remap[s] = nxt
                nxt += 1
        new_arcs: list[list[LatticeArc]] = [[] for _ in range(nxt)]
        for s, arcs in enumerate(self._arcs):
            if s in dead:
                continue
            ns = remap[s]
            for a in arcs:
                if a.dst not in dead:
                    new_arcs[ns].append(
                        LatticeArc(a.ilabel, a.olabel, a.weight, remap[a.dst]))
        self._arcs = new_arcs
        self._finals = {remap[s]: w for s, w in self._finals.items()
                        if s not in dead}
        self.start = remap.get(self.start, NO_STATE)

    def sort_arcs(self, key=None) -> None:
        """ref: lattice-fst.h SortArc (quick-sort per state)."""
        if key is None:
            key = lambda a: (a.ilabel, a.olabel, a.dst, a.weight.value)
        for arcs in self._arcs:
            arcs.sort(key=key)

    def del_same_arcs(self) -> None:
        """ref: lattice-fst.h DelSameArc — drop duplicate arcs, keeping the
        best weight among duplicates."""
        for s, arcs in enumerate(self._arcs):
            best: dict[tuple[int, int, int], LatticeArc] = {}
            order: list[tuple[int, int, int]] = []
            for a in arcs:
                k = (a.ilabel, a.olabel, a.dst)
                if k not in best:
                    best[k] = a
                    order.append(k)
                elif a.weight.value < best[k].weight.value:
                    best[k] = a
            self._arcs[s] = [best[k] for k in order]

    def invert(self) -> None:
        """Swap ilabel/olabel on every arc (ref: src/newfst/invert.h)."""
        for arcs in self._arcs:
            for a in arcs:
                a.ilabel, a.olabel = a.olabel, a.ilabel

    def rm_input(self) -> None:
        """Zero every ilabel (ref: LatticeRmInput, lattice-functions.cc:124)."""
        for arcs in self._arcs:
            for a in arcs:
                a.ilabel = EPSILON

    def scale(self, graph_scale: float = 1.0, am_scale: float = 1.0) -> None:
        """Scale (graph, acoustic) costs — lattice-scale capability used by
        rescoring pipelines (ref: src/newlm/lmrescale.cc)."""
        for arcs in self._arcs:
            for a in arcs:
                a.weight = LatticeWeight(a.weight.value1 * graph_scale,
                                         a.weight.value2 * am_scale)
        self._finals = {
            s: LatticeWeight(w.value1 * graph_scale, w.value2 * am_scale)
            for s, w in self._finals.items()}

    # -- algorithms --------------------------------------------------------
    def topsort_order(self) -> list[int] | None:
        """Topological order of states reachable from start, or None if
        cyclic (ref: src/newfst/topsort.cc, dfs-visit-fst.cc)."""
        n = self.num_states
        if self.start == NO_STATE:
            return []
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * n
        order: list[int] = []
        # iterative DFS with explicit stack to handle deep lattices
        stack: list[tuple[int, int]] = [(self.start, 0)]
        color[self.start] = GRAY
        while stack:
            s, i = stack.pop()
            arcs = self._arcs[s]
            advanced = False
            while i < len(arcs):
                d = arcs[i].dst
                i += 1
                if color[d] == GRAY:
                    return None  # cycle
                if color[d] == WHITE:
                    stack.append((s, i))
                    stack.append((d, 0))
                    color[d] = GRAY
                    advanced = True
                    break
            if not advanced:
                color[s] = BLACK
                order.append(s)
        order.reverse()
        return order

    def topsort(self) -> bool:
        """Renumber states into topological order; returns False if cyclic."""
        order = self.topsort_order()
        if order is None:
            return False
        pos = {s: i for i, s in enumerate(order)}
        # states unreachable from start are dropped
        dead = {s for s in range(self.num_states) if s not in pos}
        self.delete_states(dead)
        # after delete_states, numbering changed; recompute order
        order = self.topsort_order()
        assert order is not None
        remap = {s: i for i, s in enumerate(order)}
        new_arcs: list[list[LatticeArc]] = [[] for _ in range(len(order))]
        for s, arcs in enumerate(self._arcs):
            for a in arcs:
                new_arcs[remap[s]].append(
                    LatticeArc(a.ilabel, a.olabel, a.weight, remap[a.dst]))
        self._arcs = new_arcs
        self._finals = {remap[s]: w for s, w in self._finals.items()}
        self.start = remap[self.start]
        return True

    def is_topsorted(self) -> bool:
        """ref: TopCheck (lattice-functions.cc:108)."""
        return all(a.dst > s for s in range(self.num_states)
                   for a in self._arcs[s])

    def connect(self) -> None:
        """Trim states not both accessible and coaccessible
        (ref: src/newfst/connect-fst.cc Connect)."""
        n = self.num_states
        if self.start == NO_STATE or n == 0:
            return
        acc = np.zeros(n, bool)
        stack = [self.start]
        acc[self.start] = True
        while stack:
            s = stack.pop()
            for a in self._arcs[s]:
                if not acc[a.dst]:
                    acc[a.dst] = True
                    stack.append(a.dst)
        # reverse adjacency for coaccessibility
        radj: list[list[int]] = [[] for _ in range(n)]
        for s in range(n):
            for a in self._arcs[s]:
                radj[a.dst].append(s)
        coacc = np.zeros(n, bool)
        stack = [s for s in self._finals]
        for s in stack:
            coacc[s] = True
        while stack:
            s = stack.pop()
            for p in radj[s]:
                if not coacc[p]:
                    coacc[p] = True
                    stack.append(p)
        dead = {s for s in range(n) if not (acc[s] and coacc[s])}
        self.delete_states(dead)

    def shortest_path(self) -> list[LatticeArc]:
        """1-best path as a list of arcs (Viterbi over the DAG);
        ref: LatticeShortestPath (lattice-functions.cc:12-106)."""
        order = self.topsort_order()
        if order is None:
            raise ValueError("lattice has a cycle")
        n = self.num_states
        dist = [INF] * n
        best_in: list[tuple[int, LatticeArc] | None] = [None] * n
        if self.start == NO_STATE:
            return []
        dist[self.start] = 0.0
        for s in order:
            if dist[s] == INF:
                continue
            for a in self._arcs[s]:
                nd = dist[s] + a.weight.value
                if nd < dist[a.dst]:
                    dist[a.dst] = nd
                    best_in[a.dst] = (s, a)
        best_final, best_cost = NO_STATE, INF
        for s, w in self._finals.items():
            c = dist[s] + w.value
            if c < best_cost:
                best_final, best_cost = s, c
        if best_final == NO_STATE:
            return []
        path: list[LatticeArc] = []
        s = best_final
        while s != self.start:
            prev = best_in[s]
            assert prev is not None
            path.append(prev[1])
            s = prev[0]
        path.reverse()
        return path

    def to_vector(self) -> tuple[list[int], list[int], float, float]:
        """Best path → (words, ilabels, lm_score, am_score) including the
        terminal state's final weight;
        ref: LatticeToVector (lattice-functions.cc:179-227)."""
        path = self.shortest_path()
        words = [a.olabel for a in path if a.olabel != EPSILON]
        ilabs = [a.ilabel for a in path if a.ilabel != EPSILON]
        lm = sum(a.weight.value1 for a in path)
        am = sum(a.weight.value2 for a in path)
        end = self.start
        for a in path:
            end = a.dst
        if end != NO_STATE and self.is_final(end):
            fw = self.final(end)
            lm += fw.value1
            am += fw.value2
        return words, ilabs, lm, am

    def add_super_final(self) -> int:
        """Route all final states through ε-arcs to one new final state
        (ref: AddSuperFinalState, lattice-functions.cc:163)."""
        sf = self.add_state()
        for s, w in list(self._finals.items()):
            self.add_arc(s, LatticeArc(EPSILON, EPSILON, w, sf))
        self._finals = {sf: LatticeWeight.one()}
        return sf

    def check_format(self) -> bool:
        """ref: LatticeCheckFormat — start present, acyclic, ≥1 final."""
        return (self.start != NO_STATE and bool(self._finals)
                and self.topsort_order() is not None)

    # -- (de)serialization (binary layout mirrors the reference:
    #     ref: lattice-fst.cc Read/Write) ---------------------------------
    def _write_stream(self, f) -> None:
        f.write(struct.pack("<iii", self.start, self.num_states,
                            self.num_arcs))
        for s in range(self.num_states):
            fw = self.final(s)
            f.write(struct.pack("<iff", len(self._arcs[s]),
                                fw.value1, fw.value2))
            for a in self._arcs[s]:
                f.write(struct.pack("<iiffi", a.ilabel, a.olabel,
                                    a.weight.value1, a.weight.value2,
                                    a.dst))

    def write_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            self._write_stream(f)

    def to_bytes(self) -> bytes:
        """Wire form (same layout as the binary file) — the payload the
        post-processing service ships (ref lattice transport,
        src/post-processing-service/post-package.h)."""
        import io
        buf = io.BytesIO()
        self._write_stream(buf)
        return buf.getvalue()

    @staticmethod
    def _read_stream(f) -> "Lattice":
        lat = Lattice()
        start, nstates, narcs = struct.unpack("<iii", f.read(12))
        for _ in range(nstates):
            lat.add_state()
        lat.set_start(start)
        for s in range(nstates):
            na, f1, f2 = struct.unpack("<iff", f.read(12))
            fw = LatticeWeight(f1, f2)
            if not fw.is_zero():
                lat.set_final(s, fw)
            for _ in range(na):
                il, ol, w1, w2, d = struct.unpack("<iiffi", f.read(20))
                lat.add_arc(s, LatticeArc(il, ol, LatticeWeight(w1, w2), d))
        return lat

    @staticmethod
    def read_binary(path: str) -> "Lattice":
        with open(path, "rb") as f:
            return Lattice._read_stream(f)

    @staticmethod
    def from_bytes(data: bytes) -> "Lattice":
        import io
        return Lattice._read_stream(io.BytesIO(data))

    # -- text dump for tests ----------------------------------------------
    def to_text(self) -> str:
        out = []
        for s in range(self.num_states):
            for a in self._arcs[s]:
                out.append(f"{s}\t{a.dst}\t{a.ilabel}\t{a.olabel}\t"
                           f"{a.weight.value1:g},{a.weight.value2:g}")
        for s in self.final_states():
            w = self.final(s)
            out.append(f"{s}\t{w.value1:g},{w.value2:g}")
        return "\n".join(out)

    def __repr__(self) -> str:
        return (f"Lattice(states={self.num_states}, arcs={self.num_arcs}, "
                f"start={self.start}, finals={len(self._finals)})")
