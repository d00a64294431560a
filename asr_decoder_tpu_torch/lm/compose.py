"""Lattice ⊗ deterministic-LM composition and difference LMs.

Capability parity with the reference's rescoring stack:
  * ``LatticeComposeItf`` contract — Start/Final/GetArc on olabels
    (ref: src/newfst/compose-lat.h:8-20);
  * ``ComposeLattice`` — BFS product of a lattice with any deterministic
    automaton (ref: src/newfst/compose-lat-inl.h:15-143);
  * ``ComposeArpaLm`` — adapts an ARPA Fsa with backoff chasing
    (ref: src/newlm/compose-arpalm.h:7-33);
  * ``DiffArpaLm`` — lazy product of two LMs, G₁ pre-scaled by −lm1_scale so
    composing applies (lm2·G₂ − lm1·G₁) in one pass
    (ref: src/newlm/diff-lm.h:13-122);
  * ``ArpaLmScore`` text scoring (ref: compose-arpalm.h:26-33).
"""

from __future__ import annotations

from collections import deque
from typing import Protocol

from asr_decoder_tpu_torch.fst.lattice import EPSILON, Lattice, LatticeArc
from asr_decoder_tpu_torch.fst.semiring import LatticeWeight
from asr_decoder_tpu_torch.lm.arpa import Fsa


class LatticeComposeItf(Protocol):
    """ref: src/newfst/compose-lat.h:8-20."""

    def start(self) -> int: ...
    def final(self, s: int) -> float: ...
    def get_arc(self, s: int, olabel: int) -> tuple[int, float]: ...


class ComposeArpaLm:
    """ARPA Fsa behind the compose contract, with an LM scale."""

    def __init__(self, fsa: Fsa, scale: float = 1.0):
        self._fsa = fsa
        self._scale = scale

    def start(self) -> int:
        return self._fsa.start

    def final(self, s: int) -> float:
        return self._scale * self._fsa.final(s)

    def get_arc(self, s: int, olabel: int) -> tuple[int, float]:
        ns, c = self._fsa.get_arc(s, olabel)
        return ns, self._scale * c


class DiffArpaLm:
    """Lazy product of two LMs with weights summed; G₁ scaled by −lm1_scale
    makes composition a rescore from G₁ to G₂ (ref diff-lm.h:13-122).
    Pair states are interned (``_state_map``/``_state_vec`` in the
    reference); ``reset()`` drops the table between utterances."""

    def __init__(self, lm1: Fsa, lm2: Fsa,
                 lm1_scale: float = 1.0, lm2_scale: float = 1.0):
        self._a = ComposeArpaLm(lm1, -lm1_scale)
        self._b = ComposeArpaLm(lm2, lm2_scale)
        self.reset()

    def reset(self) -> None:
        self._map: dict[tuple[int, int], int] = {}
        self._vec: list[tuple[int, int]] = []
        self._intern((self._a.start(), self._b.start()))

    def _intern(self, pair: tuple[int, int]) -> int:
        if pair not in self._map:
            self._map[pair] = len(self._vec)
            self._vec.append(pair)
        return self._map[pair]

    def start(self) -> int:
        return 0

    def final(self, s: int) -> float:
        a, b = self._vec[s]
        return self._a.final(a) + self._b.final(b)

    def get_arc(self, s: int, olabel: int) -> tuple[int, float]:
        a, b = self._vec[s]
        na, ca = self._a.get_arc(a, olabel)
        nb, cb = self._b.get_arc(b, olabel)
        return self._intern((na, nb)), ca + cb


def compose_lattice(lat: Lattice, lm: LatticeComposeItf) -> Lattice:
    """BFS product (ref ComposeLattice, compose-lat-inl.h:15-143): follow
    lattice arcs; on a word olabel, advance the LM and add its cost to the
    graph cost; ε-olabel arcs keep the LM state.  Final weights pick up the
    LM final cost."""
    if lat.start < 0:
        return Lattice()
    out = Lattice()
    ids: dict[tuple[int, int], int] = {}

    def node(p: tuple[int, int]) -> int:
        if p not in ids:
            ids[p] = out.add_state()
        return ids[p]

    start = (lat.start, lm.start())
    out.set_start(node(start))
    q: deque[tuple[int, int]] = deque([start])
    seen = {start}
    while q:
        ls, ms = q.popleft()
        src = node((ls, ms))
        fw = lat.final(ls)
        if not fw.is_zero():
            out.set_final(src, LatticeWeight(
                fw.value1 + lm.final(ms), fw.value2))
        for a in lat.arcs(ls):
            if a.olabel == EPSILON:
                nm, add = ms, 0.0
            else:
                nm, add = lm.get_arc(ms, a.olabel)
            dst = (a.dst, nm)
            out.add_arc(src, LatticeArc(
                a.ilabel, a.olabel,
                LatticeWeight(a.weight.value1 + add, a.weight.value2),
                node(dst)))
            if dst not in seen:
                seen.add(dst)
                q.append(dst)
    out.connect()
    return out


def rescore_lattice(lat: Lattice, lm1: Fsa, lm2: Fsa,
                    lm1_scale: float = 1.0,
                    lm2_scale: float = 1.0) -> Lattice:
    """The reference's ``lat-compose`` pipeline (src/newlm/lat-compose.cc:
    16-36): lattice ⊗ (lm2·G₂ − lm1·G₁)."""
    return compose_lattice(lat, DiffArpaLm(lm1, lm2, lm1_scale, lm2_scale))


class ArpaLmScore:
    """Text scoring utility (ref compose-arpalm.h:26-33 +
    src/newlm/lmscore.cc)."""

    def __init__(self, fsa: Fsa):
        self.fsa = fsa

    def score_text(self, words: list[str]) -> float:
        ids = [self.fsa.vocab.get(w, -1) for w in words]
        return self.fsa.score_ids(ids)

    def text_to_lattice(self, word_ids: list[int]) -> Lattice:
        """Linear word lattice (for compose-text parity,
        ref src/newlm/compose-text.cc)."""
        lat = Lattice()
        s = lat.add_state()
        lat.set_start(s)
        for w in word_ids:
            nxt = lat.add_state()
            lat.add_arc(s, LatticeArc(w, w, LatticeWeight.one(), nxt))
            s = nxt
        lat.set_final(s)
        return lat
