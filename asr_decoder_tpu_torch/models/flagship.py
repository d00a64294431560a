"""Flagship streaming acoustic model.

Port of ``make_flagship`` from ``asr_decoder_tpu/models/flagship.py``: the
projected-LSTM streaming AM of the shape the reference serves (ref AM zoo:
src/nnet/nnet-component.h LSTM variants; conf: 80-dim fbank, ~2k pdfs —
src/v1-asrbin/conf/{fbank.80.conf,conf.txt}).  Weights are random, drawn
on the CPU from a seeded ``torch.Generator`` and then moved, so one seed
gives the same model on every device.  The CTC training step is not ported
yet (ROADMAP §1).
"""

from __future__ import annotations

import numpy as np
import torch

from asr_decoder_tpu_torch.models import layers as L
from asr_decoder_tpu_torch.models.nnet import Nnet


def make_flagship(seed: int, feat_dim: int = 80, num_pdfs: int = 2048,
                  hidden: int = 1024, proj: int = 512, num_layers: int = 3,
                  context: int = 1, device="cuda") -> Nnet:
    gen = torch.Generator().manual_seed(seed)
    offsets = list(range(-context, context + 1))
    spliced = feat_dim * len(offsets)
    layers = [L.make_splice(offsets, feat_dim),
              L.make_affine(gen, spliced, proj)]
    for _ in range(num_layers):
        layers.append(L.make_lstm_projected(gen, proj, hidden, proj))
    layers.append(L.make_affine(gen, proj, num_pdfs))
    layers.append(L.make_softmax(num_pdfs))
    layers.append(L.make_prior(np.ones(num_pdfs)))
    return Nnet(layers).to(device)
