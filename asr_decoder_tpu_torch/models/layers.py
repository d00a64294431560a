"""Acoustic-model layer zoo as ``nn.Module``s.

Port of ``asr_decoder_tpu/models/layers.py`` (ref: src/nnet/nnet-component.h
:8-74, nnet-layer.h:12-268, lstm-layer.cc:34-89, tf-lstm-layer.cc:34-97,
lstm-projected-layer.{h,cc}, nnet-simple-recurrent.cc:91-137).  Every layer
maps x f32[B, T, D] and a streaming state dict to (y f32[B, T, D'], state'):
the reference's ``_buffer`` carried across chunk calls, reset via
``ResetRnnBuffer`` (ref: src/nnet/nnet-nnet.h:178-188).

Weights follow the reference binary format and keep the JAX parameter
names: Affine/Linear weights are [out, in] (y = x·Wᵀ + b); LSTM gate blocks
are stacked G,I,F,O with diagonal peepholes.  Recurrences are a frame loop
of ``torch.addmm`` plus elementwise ops — ``nn.LSTM`` has neither the
peepholes nor the G,I,F,O layout — after one matrix product of the input
contribution for all frames; the steps' outputs are collected and stacked
once, which autograd differentiates without a chain of slice copies.
Weights are registered with ``requires_grad=False``: serving never builds
a graph.  ``models/flagship.py:ctc_train_step`` turns gradients on for the
model it trains.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# component-type ids of the reference binary format
# (ref: src/nnet/nnet-component.h:8-31)
KIND_IDS = {
    "affine": 0x0100,
    "linear": 0x0101,
    "lstm_projected": 0x0102,   # kLstmProjectedStreams
    "lstm": 0x0103,             # kLstm
    "lstm_cudnn": 0x0104,       # kLstmCudnn (read as plain lstm here)
    "sru": 0x0105,              # kSRU
    "tf_lstm": 0x0106,          # kTfLstm
    "softmax": 0x0107,
    "sigmoid": 0x0108,
    "splice": 0x010b,
    "add_shift": 0x010c,
    "rescale": 0x010d,
    "prior": 0x0600,
}
ID_KINDS = {v: k for k, v in KIND_IDS.items()}

RECURRENT_KINDS = ("lstm", "tf_lstm", "lstm_projected", "sru", "lstm_cudnn")

State = dict[str, torch.Tensor]


class Layer(nn.Module):
    """One component: ``kind``, dims, ``meta`` (splice offsets) and its
    named weights, registered as parameters under the JAX names."""

    def __init__(self, kind: str, input_dim: int, output_dim: int,
                 params: dict[str, torch.Tensor] | None = None,
                 meta: tuple = ()):
        super().__init__()
        self.kind = kind
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.meta = tuple(meta)
        for name, value in (params or {}).items():
            self.register_parameter(
                name, nn.Parameter(value.float(), requires_grad=False))

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))

    @property
    def is_recurrent(self) -> bool:
        return self.kind in RECURRENT_KINDS

    def init_state(self, batch: int, device=None) -> State:
        """Zero streaming state (ref ResetRnnBuffer, nnet-nnet.cc:171-205)."""
        return {}

    def forward(self, x: torch.Tensor, state: State
                ) -> tuple[torch.Tensor, State]:
        raise NotImplementedError


class Splice(Layer):
    """Frame splicing with repeat-edge padding (ref Splice::PropagateFnc +
    DnnFeat padding): offline, gather indices are clamped."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # the offsets live on the layer's device: the forward copies
        # nothing from the host, so a CUDA graph can capture it
        self.register_buffer("offsets", torch.tensor(self.meta),
                             persistent=False)

    def forward(self, x, state):
        T = x.shape[1]
        off = self.offsets.to(x.device)
        idx = (torch.arange(T, device=x.device)[:, None]
               + off[None, :]).clamp(0, T - 1)
        return x[:, idx, :].reshape(x.shape[0], T, -1), state


class AddShift(Layer):
    def forward(self, x, state):
        return x + self.shift, state


class Rescale(Layer):
    def forward(self, x, state):
        return x * self.scale, state


class Sigmoid(Layer):
    def forward(self, x, state):
        return torch.sigmoid(x), state


class Softmax(Layer):
    def forward(self, x, state):
        return torch.softmax(x, dim=-1), state


class Prior(Layer):
    """out = in − log_prior (ref: Prior::PropagateFnc, nnet-layer.cc:25-31)."""

    def forward(self, x, state):
        return x - self.log_priors, state


class Affine(Layer):
    def forward(self, x, state):
        return torch.matmul(x, self.weight.t()) + self.bias, state


class Linear(Layer):
    def forward(self, x, state):
        return torch.matmul(x, self.weight.t()), state


class Lstm(Layer):
    """Peephole LSTM, gates G,I,F,O (ref Lstm::PropagateFnc,
    lstm-layer.cc:34-89); ``tf_lstm`` is the same without peepholes
    (ref tf-lstm-layer.cc:34-97)."""

    def init_state(self, batch, device=None):
        z = torch.zeros((batch, self.output_dim), device=device)
        return {"c": z, "m": z.clone()}

    def forward(self, x, state):
        H = self.output_dim
        phole = hasattr(self, "phole_i")
        gx = torch.matmul(x, self.w_gifo_x.t()) + self.bias      # [B,T,4H]
        w_m = self.w_gifo_m.t()
        c, m = state["c"], state["m"]
        ys = []
        for t in range(x.shape[1]):
            g = torch.addmm(gx[:, t], m, w_m)
            yg, yi, yf, yo = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], \
                g[:, 3 * H:]
            if phole:
                yi = yi + self.phole_i * c
                yf = yf + self.phole_f * c
            yi = torch.sigmoid(yi)
            yf = torch.sigmoid(yf)
            c = yi * torch.tanh(yg) + yf * c
            if phole:
                yo = yo + self.phole_o * c
            m = torch.sigmoid(yo) * torch.tanh(c)
            ys.append(m)
        return torch.stack(ys, dim=1), {"c": c, "m": m}


class LstmProjected(Layer):
    """Projected peephole LSTM (ref lstm-projected-layer.{h,cc}): the
    recurrence runs over the projection r = m·W_rmᵀ, which is the output."""

    def init_state(self, batch, device=None):
        H = self.w_r_m.shape[1]
        return {"c": torch.zeros((batch, H), device=device),
                "r": torch.zeros((batch, self.output_dim), device=device)}

    def forward(self, x, state):
        H = self.w_r_m.shape[1]
        gx = torch.matmul(x, self.w_gifo_x.t()) + self.bias      # [B,T,4H]
        w_r, w_rm = self.w_gifo_r.t(), self.w_r_m.t()
        c, r = state["c"], state["r"]
        ys = []
        for t in range(x.shape[1]):
            g = torch.addmm(gx[:, t], r, w_r)
            yg, yi, yf, yo = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], \
                g[:, 3 * H:]
            yi = torch.sigmoid(yi + self.phole_i * c)
            yf = torch.sigmoid(yf + self.phole_f * c)
            c = yi * torch.tanh(yg) + yf * c
            yo = torch.sigmoid(yo + self.phole_o * c)
            r = torch.mm(yo * torch.tanh(c), w_rm)
            ys.append(r)
        return torch.stack(ys, dim=1), {"c": c, "r": r}


class Sru(Layer):
    """Simple Recurrent Unit (ref SRUcell::PropagateFnc,
    nnet-simple-recurrent.cc:91-137): c = f·c₋₁ + (1−f)·x̃;
    h = r·c + (1−r)·ah."""

    def init_state(self, batch, device=None):
        return {"c": torch.zeros((batch, self.output_dim), device=device)}

    def forward(self, x, state):
        H = self.output_dim
        xfrh = torch.matmul(x, self.w_xfrh.t())
        yx = xfrh[..., :H]
        yf = torch.sigmoid(xfrh[..., H:2 * H] + self.bias_f)
        yr = torch.sigmoid(xfrh[..., 2 * H:3 * H] + self.bias_r)
        yah = xfrh[..., 3 * H:]
        c = state["c"]
        cs = []
        for t in range(x.shape[1]):
            c = yf[:, t] * c + (1.0 - yf[:, t]) * yx[:, t]
            cs.append(c)
        return yr * torch.stack(cs, dim=1) + (1.0 - yr) * yah, {"c": c}


LAYER_CLASSES = {
    "splice": Splice,
    "add_shift": AddShift,
    "rescale": Rescale,
    "sigmoid": Sigmoid,
    "softmax": Softmax,
    "prior": Prior,
    "affine": Affine,
    "linear": Linear,
    "lstm": Lstm,
    "lstm_cudnn": Lstm,
    "tf_lstm": Lstm,
    "lstm_projected": LstmProjected,
    "sru": Sru,
}


def make_layer(kind: str, input_dim: int, output_dim: int,
               params: dict[str, torch.Tensor] | None = None,
               meta: tuple = ()) -> Layer:
    return LAYER_CLASSES[kind](kind, input_dim, output_dim, params, meta)


# ----------------------------------------------------------------------
# random-init constructors, seeded by a Generator
# ----------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * scale


def make_splice(offsets: list[int], dim: int) -> Layer:
    return make_layer("splice", dim, dim * len(offsets),
                      meta=tuple(int(o) for o in offsets))


def make_affine(gen: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 0.05) -> Layer:
    return make_layer("affine", in_dim, out_dim,
                      {"weight": _normal(gen, (out_dim, in_dim), scale),
                       "bias": torch.zeros(out_dim)})


def make_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 0.05) -> Layer:
    return make_layer("linear", in_dim, out_dim,
                      {"weight": _normal(gen, (out_dim, in_dim), scale)})


def make_lstm(gen: torch.Generator, in_dim: int, dim: int,
              peephole: bool = True, scale: float = 0.05) -> Layer:
    p = {"w_gifo_x": _normal(gen, (4 * dim, in_dim), scale),
         "w_gifo_m": _normal(gen, (4 * dim, dim), scale),
         "bias": torch.zeros(4 * dim)}
    if peephole:
        p.update(phole_i=_normal(gen, (dim,), scale),
                 phole_f=_normal(gen, (dim,), scale),
                 phole_o=_normal(gen, (dim,), scale))
    return make_layer("lstm" if peephole else "tf_lstm", in_dim, dim, p)


def make_lstm_projected(gen: torch.Generator, in_dim: int, hidden: int,
                        out_dim: int, scale: float = 0.05) -> Layer:
    p = {"w_gifo_x": _normal(gen, (4 * hidden, in_dim), scale),
         "w_gifo_r": _normal(gen, (4 * hidden, out_dim), scale),
         "bias": torch.zeros(4 * hidden),
         "phole_i": _normal(gen, (hidden,), scale),
         "phole_f": _normal(gen, (hidden,), scale),
         "phole_o": _normal(gen, (hidden,), scale),
         "w_r_m": _normal(gen, (out_dim, hidden), scale)}
    return make_layer("lstm_projected", in_dim, out_dim, p)


def make_sru(gen: torch.Generator, in_dim: int, dim: int,
             scale: float = 0.05) -> Layer:
    return make_layer("sru", in_dim, dim,
                      {"w_xfrh": _normal(gen, (4 * dim, in_dim), scale),
                       "bias_f": torch.zeros(dim),
                       "bias_r": torch.zeros(dim)})


def make_softmax(dim: int) -> Layer:
    return make_layer("softmax", dim, dim)


def make_sigmoid(dim: int) -> Layer:
    return make_layer("sigmoid", dim, dim)


def make_prior(counts: np.ndarray) -> Layer:
    """From raw state counts, as the reference computes it
    (ref: Prior::ReadData, nnet-layer.h:119-131)."""
    counts = np.asarray(counts, np.float64)
    priors = counts / counts.sum() + 1e-20
    return make_layer("prior", len(counts), len(counts),
                      {"log_priors": torch.from_numpy(
                          np.log(priors).astype(np.float32))})


def make_add_shift(shift) -> Layer:
    shift = torch.as_tensor(np.asarray(shift, np.float32))
    return make_layer("add_shift", shift.shape[-1], shift.shape[-1],
                      {"shift": shift})


def make_rescale(scale) -> Layer:
    scale = torch.as_tensor(np.asarray(scale, np.float32))
    return make_layer("rescale", scale.shape[-1], scale.shape[-1],
                      {"scale": scale})
