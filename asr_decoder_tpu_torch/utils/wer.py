"""WER scoring — accuracy harness.

Capability parity with the reference's eval tools
(ref: src/kaldi-bin/bin/nbest-compute-wer.cc — edit-distance WER over n-best
hypotheses; src/kaldi-bin/bin/lattice-best-path-score.cc).  Vectorized
Levenshtein DP in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WerStats:
    errors: int = 0       # substitutions + insertions + deletions
    subs: int = 0
    ins: int = 0
    dels: int = 0
    ref_len: int = 0
    sentences: int = 0
    wrong_sentences: int = 0

    @property
    def wer(self) -> float:
        return self.errors / max(1, self.ref_len)

    @property
    def ser(self) -> float:
        return self.wrong_sentences / max(1, self.sentences)

    def __iadd__(self, other: "WerStats"):
        for f in ("errors", "subs", "ins", "dels", "ref_len",
                  "sentences", "wrong_sentences"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self


def edit_distance(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """(total, subs, ins, dels) by Levenshtein DP with traceback counts."""
    R, H = len(ref), len(hyp)
    # dp[i,j] = (cost, subs, ins, dels) packed: cost in col 0
    dp = np.zeros((R + 1, H + 1, 4), np.int64)
    dp[:, 0, 0] = np.arange(R + 1)
    dp[:, 0, 3] = np.arange(R + 1)
    dp[0, :, 0] = np.arange(H + 1)
    dp[0, :, 2] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i, j] = dp[i - 1, j - 1]
                continue
            sub = dp[i - 1, j - 1]
            ins = dp[i, j - 1]
            dele = dp[i - 1, j]
            best = min((sub[0], 0), (ins[0], 1), (dele[0], 2))
            if best[1] == 0:
                dp[i, j] = sub + np.array([1, 1, 0, 0])
            elif best[1] == 1:
                dp[i, j] = ins + np.array([1, 0, 1, 0])
            else:
                dp[i, j] = dele + np.array([1, 0, 0, 1])
    t, s, i_, d = (int(x) for x in dp[R, H])
    return t, s, i_, d


def score_pair(ref: list, hyp: list) -> WerStats:
    t, s, i, d = edit_distance(ref, hyp)
    return WerStats(errors=t, subs=s, ins=i, dels=d, ref_len=len(ref),
                    sentences=1, wrong_sentences=int(t > 0))


def score_corpus(refs: dict[str, list], hyps: dict[str, list]) -> WerStats:
    """Aggregate WER over utterance-id-keyed transcripts; hypotheses missing
    an utterance count as all-deletions (the reference scores empty)."""
    stats = WerStats()
    for uid, ref in refs.items():
        stats += score_pair(ref, hyps.get(uid, []))
    return stats


def oracle_wer(ref: list, nbest: list[list]) -> tuple[int, int]:
    """(best error count, best index) over an n-best list — the reference's
    nbest-compute-wer oracle mode."""
    best, best_i = None, -1
    for i, hyp in enumerate(nbest or [[]]):
        t, *_ = edit_distance(ref, hyp)
        if best is None or t < best:
            best, best_i = t, i
    return int(best), best_i
