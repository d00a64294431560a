"""Flagship streaming acoustic model + CTC training step.

Port of ``asr_decoder_tpu/models/flagship.py``: the
projected-LSTM streaming AM of the shape the reference serves (ref AM zoo:
src/nnet/nnet-component.h LSTM variants; conf: 80-dim fbank, ~2k pdfs —
src/v1-asrbin/conf/{fbank.80.conf,conf.txt}).  Weights are random, drawn
on the CPU from a seeded ``torch.Generator`` and then moved, so one seed
gives the same model on every device.

Training: ``optax.ctc_loss`` becomes ``F.ctc_loss`` on the log-softmax of
the logits (blank 0, one loss a sequence, then the mean over the batch)
and ``optax.adam`` becomes ``torch.optim.Adam`` (the same defaults).  The
rule for gradients: layers are built with ``requires_grad=False`` and the
serve path runs under ``torch.inference_mode``; ``ctc_train_step`` turns
gradients on for every parameter of the model it is given and leaves them
on between steps, and whoever hands a trained model on for decoding
(``eval/harness.py:train_ctc_model``) turns them off again with
``nnet.requires_grad_(False)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from asr_decoder_tpu_torch.models import layers as L
from asr_decoder_tpu_torch.models.nnet import Nnet, am_forward


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


def flagship_logits(layers, x, state):
    """Raw pre-softmax logits (training head)."""
    return am_forward(layers, x, state, do_softmax=False, do_log=False,
                      sub_prior=False)


def ctc_loss_fn(layers, x, labels, label_paddings, state):
    """Mean over the batch of each sequence's CTC loss (blank 0, every
    frame of ``x`` used; ``label_paddings`` is 1.0 on padded label slots).

    ``reduction="none"`` and then the mean: ``reduction="mean"`` would
    divide each loss by its target length first.  int64 targets on the
    logits' device keep the loss on PyTorch's own kernel on every device.
    """
    logits, _ = flagship_logits(layers, x, state)
    B, T, _ = logits.shape
    per_seq = F.ctc_loss(
        F.log_softmax(logits, dim=-1).transpose(0, 1), labels.long(),
        input_lengths=torch.full((B,), T, dtype=torch.long),
        target_lengths=(1 - label_paddings).sum(dim=1).long(),
        blank=0, reduction="none", zero_infinity=False)
    return per_seq.mean()


def ctc_train_step(nnet: Nnet, opt: torch.optim.Adam, x, labels,
                   label_paddings, state) -> torch.Tensor:
    """One Adam CTC training step on ``nnet`` in place; returns the loss
    before the update (a 0-dim tensor on the model's device, detached).
    Gradients are on for every parameter afterwards (module docstring)."""
    with torch.enable_grad():
        nnet.requires_grad_(True)
        opt.zero_grad(set_to_none=True)
        loss = ctc_loss_fn(nnet.layers, x, labels, label_paddings, state)
        loss.backward()
        opt.step()
    return loss.detach()


def init_opt_state(nnet: Nnet, lr: float = 1e-3) -> torch.optim.Adam:
    """The optimizer over every parameter of ``nnet`` (b1 0.9, b2 0.999,
    eps 1e-8: the defaults of both ``optax.adam`` and ``torch.optim.Adam``).
    A parameter the training head never reaches (the prior) gets no
    gradient and is left as it is."""
    return torch.optim.Adam(nnet.parameters(), lr=lr)
