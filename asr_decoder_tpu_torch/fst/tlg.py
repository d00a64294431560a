"""Composed CTC decode graph T ∘ (L ∘ G): lexicon tries hanging off an
n-gram LM automaton.

This builds the framework's production-scale decode graph the way the
reference builds its HCLG (offline graph composition feeding the decoder,
ref: src/fst_format_convert_tool/README.txt, decode conf
src/v1-asrbin/conf/decoder.conf): take the ARPA-derived ``Fsa``
(``lm/arpa.py``) and expand every LM state into a **shared-prefix phone
trie** over the words leaving it, with CTC topology (repeat + in-word
blank self-loops, inter-word blank at the LM hubs) exactly as
``fst/ctc_graph.py`` builds its single-hub graph:

  * hub state per LM context state; blank self-loop; ε backoff arc to the
    backoff context's hub (weight = lm_scale · backoff_w) — the LM's
    backoff topology survives verbatim, giving the deep-ε / skewed-degree
    structure real production graphs have;
  * each word arc (s, w, cost, d) threads w's phone sequence through
    s's trie (prefixes shared ⇒ root out-degree ≤ num_phones, not vocab);
    the word olabel + lm_scale·cost ride the exit ε arc to hub(d)
    (label-pushed-late: ``olabel_anchor = "end"``);
  * hub finals = the LM's </s> cost (backoff-chased finals are reachable
    through the ε backoff chain, so only explicit finals are marked).

Grows ~Σ_arcs |phones(w)| states; a 30k-vocab 4-gram LM with a few
hundred-k n-grams lands in the reference's multi-million-state production
regime with authentic structure (trie locality + LM hub fan-in, skewed
degrees, bounded-depth ε chains).
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu_torch.fst.fst import StdFst
from asr_decoder_tpu_torch.lm.arpa import Fsa


def build_tlg(lexicon: dict[int, list[int]], fsa: Fsa, num_phones: int,
              lm_scale: float = 1.0) -> tuple[StdFst, np.ndarray]:
    """(StdFst, ilabel2pdf) for the composed CTC TLG.

    ``lexicon``: word id → phone ids (1..num_phones, no equal adjacent
    phones — same CTC constraint as ``build_ctc_decode_graph``); words in
    the Fsa without a lexicon entry are skipped (OOV).  ``ilabel2pdf``
    maps phone ilabels to AM rows 1..P and the blank ilabel (P+1) to row
    0 (ref CTC mapping, src/nnet/nnet-nnet.h:226).
    """
    blank_il = num_phones + 1
    S = fsa.num_states
    nxt = S                    # states 0..S-1 are the LM hubs
    src: list[int] = []
    il: list[int] = []
    ol: list[int] = []
    w: list[float] = []
    dst: list[int] = []

    def arc(a, b, i, o, cost):
        src.append(a)
        il.append(i)
        ol.append(o)
        w.append(cost)
        dst.append(b)

    # hub blank self-loops + backoff ε arcs
    for s in range(S):
        arc(s, s, blank_il, 0, 0.0)
        bd = int(fsa.backoff_dst[s])
        if bd >= 0:
            arc(s, bd, 0, 0, lm_scale * float(fsa.backoff_w[s]))

    trie: dict[tuple[int, int], int] = {}   # (state, phone) -> state
    off = fsa.offset
    aw, aweight, adst = fsa.arc_word, fsa.arc_weight, fsa.arc_dst
    skipped = 0
    for s in range(S):
        for k in range(int(off[s]), int(off[s + 1])):
            word = int(aw[k])
            phones = lexicon.get(word)
            if not phones:
                skipped += 1
                continue
            cur = s
            for p in phones:
                key = (cur, p)
                node = trie.get(key)
                if node is None:
                    node = nxt
                    nxt += 1
                    trie[key] = node
                    arc(cur, node, p, 0, 0.0)
                    arc(node, node, p, 0, 0.0)         # repeat collapse
                    arc(node, node, blank_il, 0, 0.0)  # in-word blank
                cur = node
            # word exit ε carries olabel + LM cost to the destination hub
            arc(cur, int(adst[k]), 0, word,
                lm_scale * float(aweight[k]))

    finals = {s: lm_scale * float(fsa.final_w[s]) for s in range(S)
              if np.isfinite(fsa.final_w[s])}
    if not finals:
        finals = {fsa.unigram: 0.0}
    fst = StdFst.from_final_weights(
        nxt, fsa.start, np.array(src, np.int64),
        np.array(il, np.int32), np.array(ol, np.int32),
        np.array(w, np.float32), np.array(dst, np.int64), finals)
    fst.olabel_anchor = "end"
    ilabel2pdf = np.concatenate([
        np.arange(num_phones + 1, dtype=np.int32), [0]])
    return fst, ilabel2pdf
