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

Two kinds have no counterpart in the reference or the JAX package: the
full-context Conformer AM's front end ``conv2d_subsample`` and its block
``conformer`` (Gulati et al. 2020, arXiv:2005.08100).  They take a padded
batch with per-row lengths (``takes_lengths``), the front end changes the
frame count (``out_lengths``), and neither streams (``streaming`` False):
each output frame reads the whole utterance.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
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
    # the port's own ids: no reference component computes these
    "conv2d_subsample": 0x0f00,
    "conformer": 0x0f01,
}
ID_KINDS = {v: k for k, v in KIND_IDS.items()}

RECURRENT_KINDS = ("lstm", "tf_lstm", "lstm_projected", "sru", "lstm_cudnn")

State = dict[str, torch.Tensor]


class Layer(nn.Module):
    """One component: ``kind``, dims, ``meta`` (splice offsets; a
    Conformer block's heads, kernel and feed-forward width) and its named
    weights, registered as parameters under the JAX names.

    ``takes_lengths``: ``forward`` takes a third argument, the real frames
    of each row (i64[B] on the input's device, or None for full rows), and
    keeps padded frames out of every real frame's output.
    ``streaming``: the layer can run chunk by chunk with its state."""

    takes_lengths = False
    streaming = True

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

    def out_lengths(self, lengths):
        """Output frames of rows of ``lengths`` input frames (an integer
        numpy array or tensor), for a kind that takes lengths: every kind
        but ``conv2d_subsample`` keeps them."""
        return lengths

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


def subsample_lengths(lengths):
    """T' = ((T − 1) // 2 − 1) // 2, at least 0: two 3x3 stride-2
    convolutions without padding (an int, integer numpy array or
    tensor)."""
    n = ((lengths - 1) // 2 - 1) // 2
    return n.clip(0) if hasattr(n, "clip") else max(n, 0)


def subsample_shapes(input_dim: int, output_dim: int) -> dict:
    """``conv2d_subsample``'s weights in blob order: two 3x3 stride-2
    Conv2d of ``output_dim`` channels, then Linear(C·F' → output_dim)."""
    C, Fp = output_dim, subsample_lengths(input_dim)
    return {"conv1_w": (C, 1, 3, 3), "conv1_b": (C,),
            "conv2_w": (C, C, 3, 3), "conv2_b": (C,),
            "out_w": (output_dim, C * Fp), "out_b": (output_dim,)}


def conformer_shapes(d: int, heads: int, kernel: int, ffn: int) -> dict:
    """A ``conformer`` block's weights in blob order (Linear weights
    [out, in]; the q, k, v projections stacked in ``att_wqkv``)."""
    ff = lambda p: {f"{p}_ln_g": (d,), f"{p}_ln_b": (d,),
                    f"{p}_w1": (ffn, d), f"{p}_b1": (ffn,),
                    f"{p}_w2": (d, ffn), f"{p}_b2": (d,)}
    return {**ff("ff1"),
            "att_ln_g": (d,), "att_ln_b": (d,),
            "att_wqkv": (3 * d, d), "att_bqkv": (3 * d,),
            "att_wpos": (d, d), "att_u": (heads, d // heads),
            "att_v": (heads, d // heads),
            "att_wo": (d, d), "att_bo": (d,),
            "conv_ln_g": (d,), "conv_ln_b": (d,),
            "conv_pw1_w": (2 * d, d), "conv_pw1_b": (2 * d,),
            "conv_dw_w": (d, kernel), "conv_dw_b": (d,),
            "bn_mean": (d,), "bn_var": (d,), "bn_g": (d,), "bn_b": (d,),
            "conv_pw2_w": (d, d), "conv_pw2_b": (d,),
            **ff("ff2"),
            "out_ln_g": (d,), "out_ln_b": (d,)}


def rel_positions(T: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table f32[2T − 1, d] of relative positions r = T − 1
    down to −(T − 1): [2i] sin(r·ω_i), [2i+1] cos(r·ω_i), ω_i =
    10000^(−2i/d) (ESPnet's ``RelPositionalEncoding``), formed in float64
    so that every r rounds once."""
    r = torch.arange(T - 1, -T, -1, device=device, dtype=torch.float64)
    w = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float64)
                  * (-math.log(10000.0) / d))
    a = r[:, None] * w[None, :]
    return torch.stack([a.sin(), a.cos()], dim=-1).reshape(
        2 * T - 1, d).float()


class Conv2dSubsample(Layer):
    """The Conformer's front end (ESPnet's ``Conv2dSubsampling``): [B, T,
    F] as one input channel → Conv2d 3x3 stride 2 → ReLU → Conv2d 3x3
    stride 2 → ReLU → [B, T', C·F'] (channel-major) → Linear → ·√d, the
    scale ESPnet's positional encoding applies to its input.  No padding:
    output frame t reads input frames 4t … 4t + 6, so a row's first
    ``subsample_lengths(len)`` outputs read only its real frames."""

    takes_lengths = True
    streaming = False

    def out_lengths(self, lengths):
        return subsample_lengths(lengths)

    def forward(self, x, state, lengths=None):
        h = F.relu(F.conv2d(x[:, None], self.conv1_w, self.conv1_b,
                            stride=2))
        h = F.relu(F.conv2d(h, self.conv2_w, self.conv2_b, stride=2))
        B, C, T, Fp = h.shape
        h = h.transpose(1, 2).reshape(B, T, C * Fp)
        y = F.linear(h, self.out_w, self.out_b)
        return y * math.sqrt(self.output_dim), state


class Conformer(Layer):
    """One Conformer block (Gulati et al. 2020, §2), for x f32[B, T, d]:
    x₁ = x + ½·FFN₁(x); x₂ = x₁ + MHSA(LN(x₁)); x₃ = x₂ + Conv(x₂);
    y = LN(x₃ + ½·FFN₂(x₃)).  FFN = LN → Linear d→ffn → Swish → Linear
    ffn→d.  MHSA: relative-position self-attention (Transformer-XL):
    head h's score of query i and key j is ((q_i + u_h)·k_j + (q_i +
    v_h)·p_{i−j}) / √(d/H), p_r = W_pos·PE(r) (``rel_positions``), keys
    past the row's length masked.  Conv = LN → pointwise d→2d → GLU →
    depthwise conv of ``kernel`` taps (padded as torch's "same": (k−1)//2
    zeros before, the rest after; padded frames zeroed first) →
    BatchNorm with running statistics → Swish → pointwise d→d.  ``meta``
    = (heads, kernel, ffn).  Layer norms and the batch norm use ε = 1e-5.

    Scores run in a [H, B, T, ·] layout: the relative term is one product
    against the 2T − 1 positions, then a strided view picks p_{i−j} (the
    rel-shift) without a copy."""

    takes_lengths = True
    streaming = False
    EPS = 1e-5

    def _ln(self, x, p):
        return F.layer_norm(x, (x.shape[-1],), getattr(self, f"{p}_g"),
                            getattr(self, f"{p}_b"), self.EPS)

    def _ffn(self, x, p):
        h = F.linear(self._ln(x, f"{p}_ln"), getattr(self, f"{p}_w1"),
                     getattr(self, f"{p}_b1"))
        return F.linear(F.silu(h), getattr(self, f"{p}_w2"),
                        getattr(self, f"{p}_b2"))

    def _mhsa(self, x, valid):
        B, T, d = x.shape
        H = self.meta[0]
        dk = d // H
        qkv = F.linear(self._ln(x, "att_ln"), self.att_wqkv, self.att_bqkv)
        qkv = qkv.view(B, T, 3, H, dk).permute(2, 3, 0, 1, 4).contiguous()
        q, k, v = qkv.unbind(0)                           # [H, B, T, dk]
        p = F.linear(rel_positions(T, d, x.device), self.att_wpos)
        p = p.view(2 * T - 1, H, dk).permute(1, 2, 0)     # [H, dk, 2T-1]
        ac = torch.matmul(q + self.att_u[:, None, None], k.transpose(2, 3))
        bd = torch.bmm((q + self.att_v[:, None, None]).view(H, B * T, dk),
                       p).view(H, B, T, 2 * T - 1)
        # bd[h, b, i, j] = the product with p_{i−j}: column T−1−i+j
        bd = bd.as_strided((H, B, T, T),
                           (B * T * (2 * T - 1), T * (2 * T - 1),
                            2 * T - 2, 1), T - 1)
        s = ac.add_(bd).mul_(1.0 / math.sqrt(dk))
        if valid is not None:
            s.masked_fill_(~valid[None, :, None, :], float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), v)     # [H, B, T, dk]
        o = o.permute(1, 2, 0, 3).reshape(B, T, d)
        return F.linear(o, self.att_wo, self.att_bo)

    def _conv(self, x, valid):
        d = x.shape[-1]
        K = self.meta[1]
        h = F.glu(F.linear(self._ln(x, "conv_ln"), self.conv_pw1_w,
                           self.conv_pw1_b), dim=-1)
        if valid is not None:
            h = h.masked_fill(~valid[..., None], 0.0)
        h = F.pad(h.transpose(1, 2), ((K - 1) // 2, K // 2))
        h = F.conv1d(h, self.conv_dw_w[:, None], self.conv_dw_b, groups=d)
        h = F.batch_norm(h, self.bn_mean, self.bn_var, self.bn_g, self.bn_b,
                         training=False, eps=self.EPS)
        return F.linear(F.silu(h).transpose(1, 2), self.conv_pw2_w,
                        self.conv_pw2_b)

    def forward(self, x, state, lengths=None):
        valid = None
        if lengths is not None:
            valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < lengths[:, None])
        x = x + 0.5 * self._ffn(x, "ff1")
        x = x + self._mhsa(x, valid)
        x = x + self._conv(x, valid)
        x = x + 0.5 * self._ffn(x, "ff2")
        return self._ln(x, "out_ln"), state


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
    "conv2d_subsample": Conv2dSubsample,
    "conformer": Conformer,
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


def _draw(gen: torch.Generator, name: str, shape) -> torch.Tensor:
    """One Conformer weight drawn so that no part is trivial: products at
    1/√fan-in, biases, u, v and the batch norm's mean at 0.1, gains and β
    near 1 and 0, variances log-normal around 1."""
    n = _normal(gen, shape, 1.0)
    if name.endswith(("_ln_g", "bn_g")):
        return 1.0 + 0.1 * n
    if name == "bn_var":
        return torch.exp(0.3 * n)
    if len(shape) >= 2 and name not in ("att_u", "att_v"):
        return n / math.sqrt(int(np.prod(shape[1:])))
    return 0.1 * n


def make_conv2d_subsample(gen: torch.Generator, in_dim: int,
                          out_dim: int) -> Layer:
    """The front end, its output Linear scaled by a further 1/√out_dim so
    that the ·√d after it leaves unit-scale frames."""
    p = {k: _draw(gen, k, s) for k, s in
         subsample_shapes(in_dim, out_dim).items()}
    p["out_w"] = p["out_w"] / math.sqrt(out_dim)
    return make_layer("conv2d_subsample", in_dim, out_dim, p)


def make_conformer(gen: torch.Generator, d: int, heads: int, kernel: int,
                   ffn: int) -> Layer:
    return make_layer("conformer", d, d,
                      {k: _draw(gen, k, s) for k, s in
                       conformer_shapes(d, heads, kernel, ffn).items()},
                      (heads, kernel, ffn))
