"""General lattice/FST graph algorithms: reverse, ε-removal, Tarjan SCC.

Completes the reference's ``newfst`` algorithm suite on the mutable
``Lattice`` (ref: src/newfst/reverse.h Reverse, src/newfst/rmepsilon.cc
RmEpsilon, src/newfst/connect-fst-all.h:14 Tarjan-SCC Connect,
src/newfst/dfs-visit-fst.cc DfsVisit access/coaccess).  Simple trim
(``Lattice.connect``) and topological sort live on the class itself;
these are the standalone transforms the reference ships as separate
headers.
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu_torch.fst.lattice import EPSILON, NO_STATE, Lattice, LatticeArc
from asr_decoder_tpu_torch.fst.semiring import INF, LatticeWeight, plus, times


def reverse(lat: Lattice) -> Lattice:
    """Reversal (ref: src/newfst/reverse.h): paths of the result are the
    reversed paths of the input.  A new super-initial state fans out to the
    input's final states carrying their final weights; the input's start
    becomes final with weight one."""
    n = lat.num_states
    out = Lattice()
    if n == 0 or lat.start == NO_STATE:
        return out
    # state i of the input maps to state i+1; state 0 is the new start
    for _ in range(n + 1):
        out.add_state()
    out.set_start(0)
    for s in range(n):
        for a in lat.arcs(s):
            out.add_arc(a.dst + 1, LatticeArc(a.ilabel, a.olabel,
                                              a.weight, s + 1))
        fw = lat.final(s)
        if fw.value1 < INF:
            out.add_arc(0, LatticeArc(EPSILON, EPSILON, fw, s + 1))
    out.set_final(lat.start + 1, LatticeWeight.one())
    return out


def _eps_closure(lat: Lattice, s: int) -> dict[int, LatticeWeight]:
    """Best ε-path weight from ``s`` to every ε-reachable state (excluding
    the trivial empty path), by worklist relaxation — requires no negative
    total-weight ε-cycles (decode lattices are ε-acyclic)."""
    from collections import deque
    dist: dict[int, LatticeWeight] = {}
    # FIFO label-correcting relaxation (Bellman-Ford-like): each state can be
    # dequeued at most num_states times on negative-cycle-free inputs, so the
    # per-state counter is a true cycle check — unlike a LIFO stack, whose
    # order is exponential on chained ε-diamond DAGs.
    work: deque[int] = deque([s])
    queued = {s}
    src = {s: LatticeWeight.one()}
    pops: dict[int, int] = {}
    limit = lat.num_states + 1
    while work:
        u = work.popleft()
        queued.discard(u)
        pops[u] = pops.get(u, 0) + 1
        if pops[u] > limit:
            raise ValueError("rmepsilon: negative-weight epsilon cycle")
        w = src[u]
        for a in lat.arcs(u):
            if a.ilabel != EPSILON or a.olabel != EPSILON:
                continue
            nw = times(w, a.weight)
            old = dist.get(a.dst)
            best = nw if old is None else plus(nw, old)
            if old is None or best != old:
                dist[a.dst] = best
                src[a.dst] = best
                if a.dst not in queued:
                    queued.add(a.dst)
                    work.append(a.dst)
    return dist


def rmepsilon(lat: Lattice) -> None:
    """In-place ε-removal (ref: src/newfst/rmepsilon.cc RmEpsilon): for
    every state, ε-paths are folded into direct copies of the non-ε arcs
    (and final weights) at their ε-reachable states; ε arcs are dropped,
    then dead states trimmed.  Path weights and label sequences are
    preserved exactly."""
    n = lat.num_states
    if n == 0 or lat.start == NO_STATE:
        return
    new_arcs: list[list[LatticeArc]] = []
    new_final: dict[int, LatticeWeight] = {}
    for s in range(n):
        keep = [a for a in lat.arcs(s)
                if a.ilabel != EPSILON or a.olabel != EPSILON]
        fw = lat.final(s)
        best_final = fw if fw.value1 < INF else None
        for d, w in _eps_closure(lat, s).items():
            for a in lat.arcs(d):
                if a.ilabel == EPSILON and a.olabel == EPSILON:
                    continue
                keep.append(LatticeArc(a.ilabel, a.olabel,
                                       times(w, a.weight), a.dst))
            dfw = lat.final(d)
            if dfw.value1 < INF:
                cand = times(w, dfw)
                best_final = cand if best_final is None \
                    else plus(best_final, cand)
        new_arcs.append(keep)
        if best_final is not None:
            new_final[s] = best_final
    lat._arcs = new_arcs
    lat._finals = new_final
    lat.del_same_arcs()
    lat.connect()


def strongly_connected_components(lat: Lattice) -> list[int]:
    """Tarjan SCC (iterative) — ``comp[s]`` per state, components numbered
    in reverse topological order (ref: src/newfst/connect-fst-all.h:14,
    connect-fst.cc).  Singleton components without self-loops are trivial."""
    n = lat.num_states
    index = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    on_stack = np.zeros(n, bool)
    comp = np.full(n, -1, np.int64)
    stack: list[int] = []
    next_index = 0
    ncomp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            s, ai = work[-1]
            if ai == 0:
                index[s] = low[s] = next_index
                next_index += 1
                stack.append(s)
                on_stack[s] = True
            arcs = lat.arcs(s)
            advanced = False
            while ai < len(arcs):
                d = arcs[ai].dst
                ai += 1
                if index[d] == -1:
                    work[-1] = (s, ai)
                    work.append((d, 0))
                    advanced = True
                    break
                if on_stack[d]:
                    low[s] = min(low[s], index[d])
            if advanced:
                continue
            work.pop()
            if low[s] == index[s]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = ncomp
                    if w == s:
                        break
                ncomp += 1
            if work:
                p = work[-1][0]
                low[p] = min(low[p], low[s])
    return [int(c) for c in comp]


def dfs_access(lat: Lattice) -> tuple[np.ndarray, np.ndarray]:
    """(accessible, coaccessible) bool masks per state
    (ref: src/newfst/dfs-visit-fst.cc access/coaccess properties)."""
    n = lat.num_states
    acc = np.zeros(n, bool)
    if n and lat.start != NO_STATE:
        work = [lat.start]
        acc[lat.start] = True
        while work:
            s = work.pop()
            for a in lat.arcs(s):
                if not acc[a.dst]:
                    acc[a.dst] = True
                    work.append(a.dst)
    radj: list[list[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in lat.arcs(s):
            radj[a.dst].append(s)
    coacc = np.zeros(n, bool)
    work = list(lat.final_states())
    for s in work:
        coacc[s] = True
    while work:
        s = work.pop()
        for p in radj[s]:
            if not coacc[p]:
                coacc[p] = True
                work.append(p)
    return acc, coacc
