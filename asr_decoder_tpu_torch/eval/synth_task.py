"""Hermetic synthetic phone task for the WER harness.

The reference's accuracy harness is external (decode → text → WER scoring
with src/kaldi-bin/bin/nbest-compute-wer.cc on fixtures not in-tree); this
framework ships a self-contained task instead: a random lexicon over P
phones, a unigram word LM, and per-phone feature templates — utterances are
sampled word sequences rendered as noisy template frames, so a CTC model is
trainable to convergence and WER is measurable end-to-end with zero external
fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SynthTask:
    num_phones: int = 20
    num_words: int = 50
    feat_dim: int = 24
    min_phone_frames: int = 3
    max_phone_frames: int = 8
    noise: float = 0.35
    sil_frames: int = 4            # leading/trailing silence (blank) frames
    seed: int = 0
    lexicon: dict[int, list[int]] = field(default_factory=dict)
    word_costs: dict[int, float] = field(default_factory=dict)
    templates: np.ndarray = None   # f32[P+1, D]; row 0 = silence/blank

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        P = self.num_phones
        # templates: well-separated random directions, unit scale
        t = rng.standard_normal((P + 1, self.feat_dim))
        self.templates = (t / np.linalg.norm(t, axis=1, keepdims=True)) \
            .astype(np.float32) * 2.0
        # lexicon: 2-5 phones per word, no adjacent repeats, unique words
        seen = set()
        probs = rng.dirichlet(np.ones(self.num_words) * 4.0)
        for w in range(1, self.num_words + 1):
            while True:
                k = int(rng.integers(2, 6))
                ph = [int(rng.integers(1, P + 1))]
                for _ in range(k - 1):
                    nxt = int(rng.integers(1, P))
                    ph.append(nxt if nxt < ph[-1] else nxt + 1)
                if tuple(ph) not in seen:
                    seen.add(tuple(ph))
                    break
            self.lexicon[w] = ph
            self.word_costs[w] = float(-np.log(probs[w - 1]))

    def sample_utterance(self, rng: np.random.Generator,
                         min_words: int = 2, max_words: int = 6):
        """(words, phones, feats f32[T, D]): unigram word sampling, random
        per-phone durations, template+noise frames, silence padding."""
        p = np.exp(-np.array([self.word_costs[w]
                              for w in range(1, self.num_words + 1)]))
        p /= p.sum()
        n = int(rng.integers(min_words, max_words + 1))
        words = list(rng.choice(np.arange(1, self.num_words + 1),
                                size=n, p=p))
        words = [int(w) for w in words]
        phones: list[int] = []
        rows: list[int] = [0] * self.sil_frames
        for w in words:
            ph = self.lexicon[w]
            phones.extend(ph)
            for q in ph:
                dur = int(rng.integers(self.min_phone_frames,
                                       self.max_phone_frames + 1))
                rows.extend([q] * dur)
            # occasional short inter-word silence
            if rng.random() < 0.5:
                rows.extend([0] * int(rng.integers(1, 4)))
        rows.extend([0] * self.sil_frames)
        feats = self.templates[np.array(rows)] + \
            rng.standard_normal((len(rows), self.feat_dim)) \
            .astype(np.float32) * self.noise
        return words, phones, feats.astype(np.float32)

    def sample_batch(self, rng: np.random.Generator, batch: int,
                     max_frames: int, max_label: int):
        """Padded CTC training batch: silence-padded feats f32[B,T,D],
        labels i32[B,L] (0-padded), label_paddings f32[B,L]."""
        feats = np.zeros((batch, max_frames, self.feat_dim), np.float32)
        labels = np.zeros((batch, max_label), np.int32)
        paddings = np.ones((batch, max_label), np.float32)
        for b in range(batch):
            while True:
                _, ph, x = self.sample_utterance(rng)
                if len(x) <= max_frames and len(ph) <= max_label:
                    break
            feats[b, :len(x)] = x
            # pad tail with noisy silence so "every frame valid" CTC holds
            pad = self.templates[0] + rng.standard_normal(
                (max_frames - len(x), self.feat_dim)) \
                .astype(np.float32) * self.noise
            feats[b, len(x):] = pad
            labels[b, :len(ph)] = ph
            paddings[b, :len(ph)] = 0.0
        return feats, labels, paddings
