"""CTC lexicon+LM decode graph builder (the TLG role).

The reference ships CTC decoding as token passing over a phone graph with
blank handling in the decoder (ref: src/old-decoder/optimize-ctc-faster-
decoder.h:63 blank-skip token passing; ilabel→pdf = ilabel-1 CTC mapping,
src/nnet/nnet-nnet.h:212-233).  Here the CTC *topology* is compiled into the
decode graph instead (the EESEN-style T∘L∘G construction), so the one TPU
beam-search kernel decodes CTC models unchanged:

  * word-loop G with unigram/bigram costs,
  * lexicon chains L (phones in, word out, word cost on the entry arc),
  * CTC T: a blank self-loop on every state and a repeat self-loop after
    each consumed phone (repeated frames collapse; blank separates).

AM output convention: row 0 = blank, rows 1..P = phones.  Arc ilabels:
phone p keeps ilabel p (pdf = p); blank uses ilabel P+1 mapped to pdf 0 —
``ilabel2pdf`` returned alongside the graph encodes exactly this.
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu_torch.fst.fst import StdFst


def build_ctc_decode_graph(
        lexicon: dict[int, list[int]], word_costs: dict[int, float],
        num_phones: int,
        share_prefixes: bool = False) -> tuple[StdFst, np.ndarray]:
    """(StdFst, ilabel2pdf) for a CTC word-loop decode graph.

    ``lexicon``: word id (≥1) → phone id sequence (ids in 1..num_phones,
    no two equal adjacent phones — CTC cannot separate them without an
    intra-word blank state, which this topology omits).
    ``word_costs``: word id → cost (e.g. −log unigram prob).

    ``share_prefixes``: build L as a phone trie (deterministic lexicon,
    the shape a determinized TLG has): common prefixes share states, the
    root's out-degree is ≤ num_phones instead of ≤ num_words, and the
    word olabel + cost move to the exit arc (olabel-pushed-late).  Use
    for large vocabularies — the flat per-word chains otherwise give the
    root a num_words out-degree that the lane-splitting rewrite turns
    into a deep ε-chain.
    """
    blank_il = num_phones + 1
    src, il, ol, w, dst = [], [], [], [], []
    s0 = 0
    nxt = 1

    def arc(a, b, i, o, cost):
        src.append(a)
        il.append(i)
        ol.append(o)
        w.append(cost)
        dst.append(b)

    arc(s0, s0, blank_il, 0, 0.0)              # inter-word blank
    trie: dict[tuple[int, int], int] = {}      # (state, phone) -> state
    for word, phones in sorted(lexicon.items()):
        assert all(1 <= p <= num_phones for p in phones), (word, phones)
        assert all(a != b for a, b in zip(phones, phones[1:])), \
            f"word {word}: adjacent repeated phone unsupported by CTC topo"
        cost = float(word_costs.get(word, 0.0))
        cur = s0
        for j, p in enumerate(phones):
            if share_prefixes and (cur, p) in trie:
                cur = trie[(cur, p)]
                continue
            n = nxt
            nxt += 1
            if share_prefixes:
                arc(cur, n, p, 0, 0.0)
                trie[(cur, p)] = n
            else:
                arc(cur, n, p, word if j == 0 else 0,
                    cost if j == 0 else 0.0)
            arc(n, n, p, 0, 0.0)               # repeat-frame collapse
            arc(n, n, blank_il, 0, 0.0)        # in-word blank
            cur = n
        if share_prefixes:                     # word exit (ε) carries the
            arc(cur, s0, 0, word, cost)        # olabel + LM cost
        else:
            arc(cur, s0, 0, 0, 0.0)            # word exit (ε)
    fst = StdFst.from_final_weights(
        nxt, s0, np.array(src), np.array(il, np.int32),
        np.array(ol, np.int32), np.array(w, np.float32),
        np.array(dst), {s0: 0.0})
    if share_prefixes:
        # the trie moves each word's olabel to its exit arc — word
        # alignment must anchor spans at the olabel's END, not start
        fst.olabel_anchor = "end"
    ilabel2pdf = np.concatenate([
        np.arange(num_phones + 1, dtype=np.int32), [0]])   # blank_il → 0
    return fst, ilabel2pdf
