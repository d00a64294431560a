"""Flagship streaming acoustic model + CTC training step.

Port of ``asr_decoder_tpu/models/flagship.py``: the
projected-LSTM streaming AM of the shape the reference serves (ref AM zoo:
src/nnet/nnet-component.h LSTM variants; conf: 80-dim fbank, ~2k pdfs —
src/v1-asrbin/conf/{fbank.80.conf,conf.txt}).  Weights are random, drawn
on the CPU from a seeded ``torch.Generator`` and then moved, so one seed
gives the same model on every device.

Training: ``ctc_loss`` is ``optax.ctc_loss`` op for op (its α floored at
``LOG_EPSILON``, so a row whose labels cannot fit its frames costs ~1e5
and keeps finite gradients, where ``F.ctc_loss`` gives inf), and
``optax.adam`` becomes ``torch.optim.Adam`` (the same defaults).  The JAX
step is one jitted program; on the card ``ctc_train_step`` is one replay
of a captured CUDA graph holding the forward, the loss, the backward and
the Adam update (``utils/cuda_graphs.py:TrainingGraphRunner``).  The rule
for gradients: layers are built with ``requires_grad=False`` and the serve
path runs under ``torch.inference_mode``; ``ctc_train_step`` turns
gradients on for every parameter of the model it is given and leaves them
on between steps, and whoever hands a trained model on for decoding
(``eval/harness.py:train_ctc_model``) turns them off again with
``nnet.requires_grad_(False)``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from asr_decoder_tpu_torch.models import layers as L
from asr_decoder_tpu_torch.models.nnet import Nnet, am_forward
from asr_decoder_tpu_torch.utils.cuda_graphs import (TrainingGraphRunner,
                                                     copy_into,
                                                     static_buffers,
                                                     static_key)

LOG_EPSILON = -1e5     # optax.ctc_loss's log(+0)


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


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` differentiated as JAX differentiates it:
    ``g·exp(a − out)``, ``g·exp(b − out)``.  ``torch.logaddexp``'s own
    backward, ``g / (1 + exp(b − a))``, reads the difference exactly where
    JAX's reads it off the rounded ``out``: near optax's floor of −1e5,
    where a float32 step is 0.0078, the two differ in the third digit in
    a row whose labels cannot fit its frames.  Inputs of one shape."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor) -> torch.Tensor:
    """Each sequence's CTC loss f32[B] of ``logits`` f32[B,T,K] against
    right-padded ``labels`` i32[B,N] (``label_paddings`` 1.0 on padded
    slots), blank 0, every frame used: ``optax.ctc_loss`` with all-zero
    ``logit_paddings``, whose blend ``pad·prev + (1−pad)·next`` is then
    ``next`` exactly and is left out.

    Tensor ops on the logits' device only, no host read, so a CUDA graph
    can capture it.  The emissions come from a one-hot product, as in
    optax: its backward is a batched product, deterministic, where a
    gather's backward is a scatter-add whose atomics may sum duplicate
    labels in another order on every run.
    """
    B, T, K = logits.shape
    N = labels.shape[1]
    dev = logits.device
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_paddings.sum(dim=1).to(torch.int32)
    repeat = torch.zeros((B, N), dtype=logits.dtype, device=dev)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    eps_repeat = LOG_EPSILON * repeat            # emit → φ, next label repeats
    eps_other = LOG_EPSILON * (1.0 - repeat)     # emit → φ by a blank

    logprobs_phi = logprobs[:, :, :1]                               # [B,T,1]
    one_hot = (labels[:, :, None] == torch.arange(K, device=dev)).to(
        logits.dtype)                                               # [B,N,K]
    logprobs_emit = torch.bmm(logprobs, one_hot.transpose(1, 2))    # [B,T,N]

    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=logits.dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPSILON, dtype=logits.dtype, device=dev)

    def add_to_phi(phi, added):
        """``phi[:, 1:]`` ⊕ ``added`` in log space (optax's
        ``update_phi_score``)."""
        return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], added)],
                         dim=1)

    for t in range(T):
        lp_emit, lp_phi = logprobs_emit[:, t], logprobs_phi[:, t]
        prev_emit = emit
        phi = add_to_phi(phi, prev_emit + eps_repeat)
        emit = _LogAddExp.apply(phi[:, :-1] + lp_emit, prev_emit + lp_emit)
        phi = add_to_phi(phi + lp_phi, prev_emit + lp_phi + eps_other)
    phi = add_to_phi(phi, emit)
    at_len = (torch.arange(N + 1, device=dev) == labellens[:, None]).to(
        logits.dtype)
    return -(phi * at_len).sum(dim=1)


def ctc_loss_fn(layers, x, labels, label_paddings, state):
    """Mean over the batch of each sequence's ``ctc_loss`` (blank 0, every
    frame of ``x`` used), as the JAX ``ctc_loss_fn``."""
    logits, _ = flagship_logits(layers, x, state)
    return ctc_loss(logits, labels, label_paddings).mean()


# each optimizer's training runners, a key each; weak, so a dropped
# optimizer takes its runners (and their graphs and memory pools) with it
_TRAIN_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _train_runner(nnet: Nnet, opt: torch.optim.Adam,
                  inputs: list) -> TrainingGraphRunner:
    """The runner of ``opt``'s step over ``nnet.layers`` for the shapes,
    dtypes and device of ``inputs`` (x, labels, paddings, state)."""
    device = next(nnet.parameters()).device
    key = (id(nnet.layers), str(device), static_key(inputs))
    runners = _TRAIN_GRAPHS.setdefault(opt, {})
    run = runners.get(key)
    if run is None:
        # the layers, not the model, and the optimizer weakly: the runner
        # keeps neither its optimizer nor the model object alive
        layers, opt_ref = nnet.layers, weakref.ref(opt)

        def step(b):
            opt = opt_ref()
            opt.zero_grad(set_to_none=True)
            loss = ctc_loss_fn(layers, *b)
            loss.backward()
            opt.step()
            return loss.detach()
        run = runners[key] = TrainingGraphRunner(
            step, static_buffers(inputs, device), device,
            list(nnet.parameters()))
    return run


def ctc_train_step(nnet: Nnet, opt: torch.optim.Adam, x, labels,
                   label_paddings, state) -> torch.Tensor:
    """One Adam CTC training step on ``nnet`` in place; returns the loss
    before the update (a 0-dim tensor on the model's device, detached).

    On the card the step is one replay of a captured CUDA graph (the
    counterpart of the JAX jit), one graph for each key: ``opt``, the
    model, the device and the shapes and dtypes of the inputs.  The first
    step of a key runs eagerly and then captures; the inputs go in through
    the runner's static buffers.  On the CPU the same body runs on the same
    buffers.  Gradients are on for every parameter afterwards (module
    docstring), and after every step each ``.grad`` holds that step's
    gradient (on the card in the graph's memory, which the next step
    rewrites).
    """
    nnet.requires_grad_(True)
    inputs = [x, labels, label_paddings, state]
    run = _train_runner(nnet, opt, inputs)
    with run.lock:
        copy_into(run.buffers, inputs)
        return run().clone()


def init_opt_state(nnet: Nnet, lr: float = 1e-3) -> torch.optim.Adam:
    """The optimizer over every parameter of ``nnet`` (b1 0.9, b2 0.999,
    eps 1e-8: the defaults of both ``optax.adam`` and ``torch.optim.Adam``).
    A parameter the training head never reaches (the prior) gets no
    gradient and is left as it is.

    On the card it is ``capturable``: its step counts live on the device,
    so a captured step updates them.  The learning rate is a constant of
    the captured graph, as the JAX step's ``optax.adam(lr)`` is: a caller
    that changed ``param_groups[0]["lr"]`` after the first step would not
    move it, and the harness holds it fixed."""
    params = list(nnet.parameters())
    return torch.optim.Adam(params, lr=lr,
                            capturable=all(p.is_cuda for p in params))
