# Frozen copy of asr_decoder_tpu_torch/lm/synth_arpa.py, unchanged: the benchmark makes
# its own graphs, so that neither the program nor the plain reference makes
# the input that both are given.
"""Synthetic ARPA n-gram LM generator (bench / test fixture).

Produces a structurally honest ARPA file at arbitrary scale: hierarchical
n-grams (every higher-order n-gram extends an existing lower-order context,
as real LM training yields), log10 probabilities, backoff weights — fed
through the repo's own ``parse_arpa`` → ``Fsa`` path so the composed TLG
bench graph exercises the real LM-build machinery rather than a synthetic
FSA (VERDICT r4 #5: the reference's production HCLG regime is exactly this
backoff topology, ref: src/newlm/arpa2fsa.cc).
"""

from __future__ import annotations

import numpy as np


def synth_arpa_text(vocab_size: int, n_bigram: int, n_trigram: int = 0,
                    n_4gram: int = 0, seed: int = 0) -> str:
    """ARPA text with ``vocab_size`` unigrams (word names "w<i>") plus
    hierarchically-sampled higher-order n-grams."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(1, vocab_size + 1)]
    out = ["\\data\\", f"ngram 1={vocab_size + 2}"]
    orders = [(2, n_bigram), (3, n_trigram), (4, n_4gram)]
    orders = [(o, c) for o, c in orders if c > 0]
    for o, c in orders:
        out.append(f"ngram {o}={c}")
    max_order = orders[-1][0] if orders else 1

    def lp(scale=1.0):
        return f"{-1.0 - 3.0 * rng.random() * scale:.4f}"

    def bo():
        return f"{-0.3 - rng.random():.4f}"

    out += ["", "\\1-grams:"]
    out.append(f"{lp()}\t<s>\t{bo()}")
    out.append(f"{lp()}\t</s>")
    for w in words:
        out.append(f"{lp()}\t{w}\t{bo()}"
                   if max_order > 1 else f"{lp()}\t{w}")

    # contexts[o] = list of o-tuples usable as (o+1)-gram contexts
    contexts = {1: [("<s>",)] + [(w,) for w in words]}
    for o, c in orders:
        out += ["", f"\\{o}-grams:"]
        ctxs = contexts[o - 1]
        pick_ctx = rng.integers(0, len(ctxs), c)
        pick_w = rng.integers(0, vocab_size, c)
        seen = set()
        new_ctx = []
        has_bo = o < max_order
        for ci, wi in zip(pick_ctx, pick_w):
            gram = ctxs[ci] + (words[wi],)
            if gram in seen:
                continue
            seen.add(gram)
            line = f"{lp(0.5)}\t" + " ".join(gram)
            if has_bo:
                line += f"\t{bo()}"
                new_ctx.append(gram)
            out.append(line)
        contexts[o] = new_ctx
    out += ["", "\\end\\", ""]
    return "\n".join(out)
