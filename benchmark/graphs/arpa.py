# Frozen copy of asr_decoder_tpu_torch/lm/arpa.py, unchanged: the benchmark makes
# its own graphs, so that neither the program nor the plain reference makes
# the input that both are given.
"""ARPA back-off language model as a finite-state automaton.

Capability parity with the reference's ``ArpaLm``/``Fsa``
(ref: src/newlm/arpa2fsa.h:23-342,345-563, arpa2fsa.cc): parse an ARPA text
LM into an FSA whose states are n-gram contexts, with per-state
binary-searched sorted word arcs (``SearchArc``/``GetArc``,
arpa2fsa.cc:244-262), a backoff transition per state (wordid 0 ⇒ backoff, as
in the reference), ``Rescale`` (used to negate G₁ for difference LMs,
arpa2fsa.cc:264), and a binary serialization.

Where the reference shards the ARPA text by n-gram order across pthreads
(arpa2fsa.h:483-563), this build parses into numpy arrays and assembles the
CSR vectorized — the host equivalent of the same throughput goal without
mutex-guarded node insertion.

Weights are costs in natural log: cost = -ln(10)·log10(p).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

import numpy as np

LN10 = math.log(10.0)
BACKOFF_LABEL = 0        # wordid 0 on a backoff transition (ref convention)

_MAGIC = b"ATFSA001"


@dataclass
class Fsa:
    """Context-state LM automaton in CSR form.

    State ``s`` owns sorted word arcs ``offset[s]:offset[s+1]`` over
    (``arc_word``, ``arc_weight``, ``arc_dst``); ``backoff_w``/``backoff_dst``
    give its backoff transition (dst −1 at the root).  ``start`` is the
    <s> context, ``unigram`` the empty context; ``final_w[s]`` the </s>
    cost from s (+inf if unreachable).
    """

    start: int
    unigram: int
    offset: np.ndarray        # i64[S+1]
    arc_word: np.ndarray      # i32[A] sorted within each state
    arc_weight: np.ndarray    # f32[A]
    arc_dst: np.ndarray       # i32[A]
    backoff_w: np.ndarray     # f32[S]
    backoff_dst: np.ndarray   # i32[S]
    final_w: np.ndarray       # f32[S]
    vocab: dict[str, int] = field(default_factory=dict)

    @property
    def num_states(self) -> int:
        return len(self.offset) - 1

    @property
    def num_arcs(self) -> int:
        return len(self.arc_word)

    # -- lookup (ref: Fsa::GetArc backoff chase, arpa2fsa.cc:244-262) ------
    def find_arc(self, s: int, word: int) -> int:
        """Binary search state s's arcs for word; −1 if absent."""
        lo, hi = int(self.offset[s]), int(self.offset[s + 1])
        i = int(np.searchsorted(self.arc_word[lo:hi], word)) + lo
        if i < hi and self.arc_word[i] == word:
            return i
        return -1

    def get_arc(self, s: int, word: int) -> tuple[int, float]:
        """(next_state, cost) for emitting ``word`` from context ``s``,
        chasing backoffs; cost accumulates backoff weights."""
        cost = 0.0
        while True:
            i = self.find_arc(s, word)
            if i >= 0:
                return int(self.arc_dst[i]), cost + float(self.arc_weight[i])
            bd = int(self.backoff_dst[s])
            if bd < 0:
                # unseen word even at unigram level: big penalty, stay
                return s, cost + 100.0
            cost += float(self.backoff_w[s])
            s = bd

    def final(self, s: int) -> float:
        """Cost of ending the sentence (</s>) from context ``s``, chasing
        backoffs."""
        cost = 0.0
        while True:
            f = float(self.final_w[s])
            if np.isfinite(f):
                return cost + f
            bd = int(self.backoff_dst[s])
            if bd < 0:
                return cost + 100.0
            cost += float(self.backoff_w[s])
            s = bd

    def score_ids(self, words: list[int]) -> float:
        """Total cost of a sentence (word ids, excl. <s>/</s>)."""
        s = self.start
        total = 0.0
        for w in words:
            s, c = self.get_arc(s, w)
            total += c
        return total + self.final(s)

    def rescale(self, scale: float) -> "Fsa":
        """Multiply all weights (ref Fsa::Rescale, arpa2fsa.cc:264) —
        returns a view-sharing copy with scaled weights."""
        return Fsa(start=self.start, unigram=self.unigram,
                   offset=self.offset, arc_word=self.arc_word,
                   arc_weight=(self.arc_weight * scale).astype(np.float32),
                   arc_dst=self.arc_dst,
                   backoff_w=(self.backoff_w * scale).astype(np.float32),
                   backoff_dst=self.backoff_dst,
                   final_w=(self.final_w * scale).astype(np.float32),
                   vocab=self.vocab)

    # -- binary serialization (own format; role of arpa2fsa.cc:8-176) ------
    def write_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<iiqq", self.start, self.unigram,
                                self.num_states, self.num_arcs))
            self.offset.astype("<i8").tofile(f)
            self.arc_word.astype("<i4").tofile(f)
            self.arc_weight.astype("<f4").tofile(f)
            self.arc_dst.astype("<i4").tofile(f)
            self.backoff_w.astype("<f4").tofile(f)
            self.backoff_dst.astype("<i4").tofile(f)
            self.final_w.astype("<f4").tofile(f)
            vocab_blob = "\n".join(
                f"{w}\t{i}" for w, i in self.vocab.items()).encode()
            f.write(struct.pack("<q", len(vocab_blob)))
            f.write(vocab_blob)

    @staticmethod
    def read_binary(path: str) -> "Fsa":
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise IOError(f"{path}: not an Fsa binary")
            start, unigram, S, A = struct.unpack("<iiqq", f.read(24))
            offset = np.fromfile(f, "<i8", S + 1)
            arc_word = np.fromfile(f, "<i4", A)
            arc_weight = np.fromfile(f, "<f4", A)
            arc_dst = np.fromfile(f, "<i4", A)
            backoff_w = np.fromfile(f, "<f4", S)
            backoff_dst = np.fromfile(f, "<i4", S)
            final_w = np.fromfile(f, "<f4", S)
            n, = struct.unpack("<q", f.read(8))
            vocab = {}
            if n:
                for line in f.read(n).decode().splitlines():
                    w, i = line.split("\t")
                    vocab[w] = int(i)
        return Fsa(start, unigram, offset, arc_word, arc_weight, arc_dst,
                   backoff_w, backoff_dst, final_w, vocab)


class ArpaParseError(ValueError):
    pass


def parse_arpa(text: str, word2id: dict[str, int] | None = None) -> Fsa:
    """ARPA text → Fsa (ref Arpa2Fsa::NgramToFsa + AnalyLine,
    arpa2fsa.cc).  ``word2id``: external symbol table (e.g. words.txt); if
    None an internal vocabulary is built in first-seen order from id 1."""
    lines = text.splitlines()
    # locate sections
    counts: dict[int, int] = {}
    i = 0
    n = len(lines)
    while i < n and lines[i].strip() != "\\data\\":
        i += 1
    if i == n:
        raise ArpaParseError("missing \\data\\ section")
    i += 1
    while i < n:
        ln = lines[i].strip()
        if not ln:
            i += 1
            continue
        if ln.startswith("ngram "):
            order, cnt = ln[6:].split("=")
            counts[int(order)] = int(cnt)
            i += 1
        else:
            break
    if not counts:
        raise ArpaParseError("no ngram counts")
    max_order = max(counts)

    own_vocab = word2id is None
    vocab: dict[str, int] = {} if own_vocab else dict(word2id)

    def wid(w: str) -> int:
        if w in vocab:
            return vocab[w]
        if own_vocab:
            vocab[w] = len(vocab) + 1
            return vocab[w]
        raise ArpaParseError(f"word {w!r} not in the given symbol table")

    # ngrams[order] = list of (ids tuple, cost, backoff_cost)
    ngrams: dict[int, list[tuple[tuple, float, float]]] = \
        {o: [] for o in counts}
    order = None
    while i < n:
        ln = lines[i].strip()
        i += 1
        if not ln:
            continue
        if ln == "\\end\\":
            break
        if ln.startswith("\\") and ln.endswith("-grams:"):
            order = int(ln[1:ln.index("-")])
            continue
        if order is None:
            continue
        parts = ln.split()
        if len(parts) < order + 1:
            raise ArpaParseError(f"bad {order}-gram line: {ln!r}")
        logp = float(parts[0])
        words = tuple(wid(w) for w in parts[1:1 + order])
        bo = float(parts[1 + order]) if len(parts) > order + 1 else 0.0
        ngrams[order].append((words, logp * -LN10, bo * -LN10))

    BOS = vocab.get("<s>", -1)
    EOS = vocab.get("</s>", -2)

    # ---- states = contexts -----------------------------------------------
    # a context (w1..wk), k < max_order, is a state if it appears as a
    # k-gram with continuations or backoff.  Create states for all ngrams
    # of order < max_order, plus the empty (unigram) context.
    state_of: dict[tuple, int] = {(): 0}

    def ensure_state(ctx: tuple) -> int:
        if ctx not in state_of:
            state_of[ctx] = len(state_of)
        return state_of[ctx]

    for o in range(1, max_order):
        for words, _, _ in ngrams.get(o, []):
            if words[-1] != EOS:
                ensure_state(words)

    def suffix_state(ctx: tuple) -> int:
        """Longest suffix of ctx that is a state."""
        while ctx not in state_of:
            ctx = ctx[1:]
        return state_of[ctx]

    S = len(state_of)
    arcs: list[list[tuple[int, float, int]]] = [[] for _ in range(S)]
    backoff_w = np.zeros(S, np.float32)
    backoff_dst = np.full(S, -1, np.int32)
    final_w = np.full(S, np.inf, np.float32)

    for o in range(1, max_order + 1):
        for words, cost, bo in ngrams.get(o, []):
            ctx, w = words[:-1], words[-1]
            if ctx not in state_of:
                continue  # unreachable higher-order entry
            s = state_of[ctx]
            if w == EOS:
                final_w[s] = cost
                continue
            if w == BOS:
                # <s> is not emitted; its backoff weight applies to the
                # start state (set below)
                if words in state_of:
                    st = state_of[words]
                    backoff_w[st] = bo
                    backoff_dst[st] = suffix_state(words[1:])
                continue
            dst = suffix_state(words) if o < max_order \
                else suffix_state(words[1:])
            arcs[s].append((w, cost, dst))
            if o < max_order and words in state_of:
                st = state_of[words]
                backoff_w[st] = bo
                backoff_dst[st] = suffix_state(words[1:])

    start = state_of.get((BOS,), 0)

    # ---- pack CSR with sorted words per state -----------------------------
    offset = np.zeros(S + 1, np.int64)
    for s in range(S):
        arcs[s].sort()
        offset[s + 1] = offset[s] + len(arcs[s])
    A = int(offset[-1])
    arc_word = np.empty(A, np.int32)
    arc_weight = np.empty(A, np.float32)
    arc_dst = np.empty(A, np.int32)
    for s in range(S):
        for k, (w, c, d) in enumerate(arcs[s]):
            p = int(offset[s]) + k
            arc_word[p] = w
            arc_weight[p] = c
            arc_dst[p] = d

    return Fsa(start=start, unigram=0, offset=offset, arc_word=arc_word,
               arc_weight=arc_weight, arc_dst=arc_dst, backoff_w=backoff_w,
               backoff_dst=backoff_dst, final_w=final_w, vocab=vocab)


def read_arpa(path: str, word2id: dict[str, int] | None = None) -> Fsa:
    with open(path, encoding="utf-8", errors="replace") as f:
        return parse_arpa(f.read(), word2id)
