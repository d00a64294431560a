"""The decode graphs the benchmark hands to the program and to the plain
reference: raw arc lists made from the configuration, never by the
program.  ``random_hclg`` is a frozen copy of the port's
``fst/synthetic.py`` generator; ``build_tlg`` is the port's ``fst/tlg.py``
composition over frozen copies of its ARPA generator and parser, returning
arrays instead of a ``StdFst``.

A ``RawGraph`` keeps the arcs as generated, before any super-final rewrite:
``finals`` maps a state to its final weight.  The program builds its own
``StdFst`` from them (``to_port``); the reference builds its own arc index
(``reference/graph.py``)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class RawGraph:
    num_states: int
    start: int
    src: np.ndarray          # i64[E]
    ilabel: np.ndarray       # i32[E], 0 = epsilon
    olabel: np.ndarray       # i32[E], 0 = no word
    weight: np.ndarray       # f32[E]
    dst: np.ndarray          # i64[E]
    finals: dict             # state -> final weight
    ilabel2pdf: np.ndarray   # i32: ilabel -> AM output row
    lexicon: dict = field(default_factory=dict)   # word -> phones (TLG)
    num_phones: int = 0

    @property
    def num_arcs(self) -> int:
        return len(self.src)


def random_hclg(seed: int, num_states: int, num_ilabels: int,
                num_words: int = 5000, min_degree: int = 2,
                max_degree: int = 8, eps_frac: float = 0.08,
                self_loop_frac: float = 0.4) -> RawGraph:
    """HCLG-shaped random graph (the port's ``fst/synthetic.py:
    random_hclg``, same draws from ``default_rng(seed)``); ilabel i scores
    AM row i - 1 (the CTC map)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(min_degree, max_degree + 1, num_states)
    total = int(deg.sum())
    src = np.repeat(np.arange(num_states, dtype=np.int64), deg)
    lane = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    dst = rng.integers(0, num_states, total).astype(np.int64)
    chain = np.minimum(src + 1, num_states - 1)
    dst = np.where(lane == 0, chain, dst)
    is_self = (lane > 0) & (rng.random(total) < self_loop_frac)
    dst = np.where(is_self, src, dst)
    ilabel = rng.integers(1, num_ilabels + 1, total).astype(np.int64)
    can_eps = (lane == 0) & (src % 8 < 3) & (dst > src)
    p_eps = min(1.0, eps_frac / max(float(can_eps.mean()), 1e-9))
    is_eps = can_eps & (rng.random(total) < p_eps)
    ilabel = np.where(is_eps, 0, ilabel)
    olabel = np.where(rng.random(total) < 0.1,
                      rng.integers(1, num_words + 1, total), 0)
    weight = rng.random(total).astype(np.float32) * 4.0
    finals = {num_states - 1: 0.0,
              int(num_states * 0.75): float(rng.random())}
    i2p = np.concatenate([[0], np.arange(num_ilabels)]).astype(np.int32)
    return RawGraph(num_states, 0, src, ilabel.astype(np.int32),
                    olabel.astype(np.int32), weight, dst, finals, i2p)


def build_tlg(lm: dict, num_phones: int, lm_seed: int = 1,
              lexicon_seed: int = 1) -> RawGraph:
    """The composed CTC TLG: ``synth_arpa_text(**lm, seed=lm_seed)`` ->
    ``parse_arpa`` -> a lexicon of 3-7 phones a word (no equal neighbours)
    from ``default_rng(lexicon_seed)`` -> hub blank loops and backoff
    epsilons, a phone trie a hub, word-exit epsilons carrying the word and
    its LM cost (the port's ``fst/tlg.py:build_tlg`` at ``lm_scale`` 1).
    Phones 1..P score AM rows 1..P, the blank ilabel P + 1 row 0."""
    from benchmark.graphs.arpa import parse_arpa
    from benchmark.graphs.synth_arpa import synth_arpa_text
    fsa = parse_arpa(synth_arpa_text(**lm, seed=lm_seed))
    rng = np.random.default_rng(lexicon_seed)
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if not wname.startswith("w"):
            continue
        n = int(rng.integers(3, 8))
        ph = [int(rng.integers(1, num_phones + 1))]
        while len(ph) < n:
            p = int(rng.integers(1, num_phones + 1))
            if p != ph[-1]:
                ph.append(p)
        lexicon[wid] = ph
    blank = num_phones + 1
    S = fsa.num_states
    nxt = S
    src, il, ol, w, dst = [], [], [], [], []

    def arc(a, b, i, o, cost):
        src.append(a)
        il.append(i)
        ol.append(o)
        w.append(cost)
        dst.append(b)

    for s in range(S):
        arc(s, s, blank, 0, 0.0)
        bd = int(fsa.backoff_dst[s])
        if bd >= 0:
            arc(s, bd, 0, 0, float(fsa.backoff_w[s]))
    trie: dict = {}
    off = fsa.offset
    for s in range(S):
        for k in range(int(off[s]), int(off[s + 1])):
            word = int(fsa.arc_word[k])
            phones = lexicon.get(word)
            if not phones:
                continue
            cur = s
            for p in phones:
                node = trie.get((cur, p))
                if node is None:
                    node = nxt
                    nxt += 1
                    trie[(cur, p)] = node
                    arc(cur, node, p, 0, 0.0)
                    arc(node, node, p, 0, 0.0)
                    arc(node, node, blank, 0, 0.0)
                cur = node
            arc(cur, int(fsa.arc_dst[k]), 0, word, float(fsa.arc_weight[k]))
    finals = {s: float(fsa.final_w[s]) for s in range(S)
              if np.isfinite(fsa.final_w[s])}
    if not finals:
        finals = {int(fsa.unigram): 0.0}
    i2p = np.concatenate([np.arange(num_phones + 1, dtype=np.int32), [0]])
    return RawGraph(nxt, int(fsa.start), np.array(src, np.int64),
                    np.array(il, np.int32), np.array(ol, np.int32),
                    np.array(w, np.float32), np.array(dst, np.int64), finals,
                    i2p.astype(np.int32), lexicon, num_phones)


def save(g: RawGraph, path: Path) -> None:
    """One ``.npz`` a graph, written under a temporary name and renamed,
    so a reader never sees half a file."""
    lex = list(g.lexicon.items())
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, meta=json.dumps({"num_states": g.num_states,
                                   "start": g.start,
                                   "num_phones": g.num_phones}),
             src=g.src, ilabel=g.ilabel, olabel=g.olabel, weight=g.weight,
             dst=g.dst, final_s=np.array(list(g.finals), np.int64),
             final_w=np.array(list(g.finals.values()), np.float64),
             i2p=g.ilabel2pdf,
             lex_words=np.array([w for w, _ in lex], np.int64),
             lex_len=np.array([len(p) for _, p in lex], np.int64),
             lex_phones=np.array([q for _, p in lex for q in p], np.int32))
    tmp.replace(path)


def load(path: Path) -> RawGraph:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    ends = np.cumsum(z["lex_len"])
    phones = z["lex_phones"].tolist()
    lexicon = {int(w): phones[e - n:e]
               for w, n, e in zip(z["lex_words"], z["lex_len"], ends)}
    return RawGraph(meta["num_states"], meta["start"], z["src"], z["ilabel"],
                    z["olabel"], z["weight"], z["dst"],
                    dict(zip(z["final_s"].tolist(), z["final_w"].tolist())),
                    z["i2p"], lexicon, meta["num_phones"])


def make_graph(spec: dict, cache_dir: Path, log=print) -> RawGraph:
    """The configuration's graph: ``spec["kind"]`` is ``random_hclg`` (made
    in about a second) or ``tlg`` (made once per checkout into
    ``cache_dir`` and read from there afterwards)."""
    kw = {k: v for k, v in spec.items() if k != "kind"}
    if spec["kind"] == "random_hclg":
        return random_hclg(**kw)
    if spec["kind"] != "tlg":
        raise ValueError(f"unknown graph kind {spec['kind']!r}")
    key = "_".join(f"{k}{v}" for k, v in sorted(kw["lm"].items()))
    path = cache_dir / f"tlg_{key}_p{kw['num_phones']}.npz"
    if path.exists():
        return load(path)
    t0 = time.perf_counter()
    g = build_tlg(**kw)
    cache_dir.mkdir(parents=True, exist_ok=True)
    save(g, path)
    log(f"built the TLG ({g.num_states} states, {g.num_arcs} arcs) in "
        f"{time.perf_counter() - t0:.1f} s into {path}")
    return g
