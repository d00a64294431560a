"""A plain reference of the full-context Conformer AM (Gulati et al. 2020,
"Conformer: Convolution-augmented Transformer for Speech Recognition",
arXiv:2005.08100, Table 1), for the tests: plain ``torch`` in float32
with TF32 off, one utterance at its own length, no padding, no batch, no
cache, no graph.  It imports nothing of either package: the layers come
in as ``[(kind, {name: tensor})]`` under the weight names of the port's
``models/layers.py`` (``conformer_shapes``, ``subsample_shapes``).

For fbank frames x f32[T, F]:

* front end: two 3x3 stride-2 convolutions without padding, each with
  ReLU, over x as one input channel; the [T', C, F'] output flattened
  channel-major, a Linear to d, times √d;
* each block: x₁ = x + ½·FFN(x); x₂ = x₁ + MHSA(LN(x₁)); x₃ = x₂ +
  Conv(x₂); y = LN(x₃ + ½·FFN(x₃)), with FFN = LN → Linear → Swish →
  Linear; the score of head h, query i and key j ((q_i + u_h)·k_j + (q_i
  + v_h)·p_{i−j}) / √(d/H), p_r = W_pos·PE(r); Conv = LN → pointwise
  d→2d → GLU → depthwise conv → BatchNorm → Swish → pointwise d→d;
* head: affine, softmax, log, minus the log prior.

Departures from the paper, each an assumption of the configuration:

* the paper's decoder (a one-layer LSTM transducer over wordpieces) is
  replaced by a softmax over the graph's pdfs with a prior, a hybrid
  model's head;
* the paper gives no layer detail of its convolution subsampling: this
  is ESPnet's ``Conv2dSubsampling`` (C = d channels), with the √d scale
  that ESPnet's positional encoding applies to its input;
* PE(r) is ESPnet's sinusoidal table: [2i] sin(r·ω_i), [2i+1] cos(r·ω_i),
  ω_i = 10000^(−2i/d), formed in float64; W_pos has no bias;
* an even depthwise kernel (the paper's 32) is padded with (k−1)//2
  zeros before and the rest after, as torch's ``padding="same"``;
* the batch norm runs in inference form, from running statistics;
  layer and batch norms use ε = 1e-5; there is no dropout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-5


def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * g + b


def _linear(x, w, b=None):
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def _swish(x):
    return x * torch.sigmoid(x)


def _conv3x3_s2(x, w, b):
    """x f32[Cin, T, F] → f32[Cout, (T−1)//2, (F−1)//2]: each output the
    sum over its 3x3xCin input patch (an explicit patch matrix)."""
    cout = w.shape[0]
    patches = x.unfold(1, 3, 2).unfold(2, 3, 2)        # [Cin, T', F', 3, 3]
    cin, T, F = patches.shape[:3]
    cols = patches.permute(1, 2, 0, 3, 4).reshape(T * F, cin * 9)
    y = torch.matmul(cols, w.reshape(cout, cin * 9).t()) + b
    return y.t().reshape(cout, T, F)


def _subsample(x, p):
    h = torch.relu(_conv3x3_s2(x[None], p["conv1_w"], p["conv1_b"]))
    h = torch.relu(_conv3x3_s2(h, p["conv2_w"], p["conv2_b"]))
    C, T, F = h.shape
    h = h.permute(1, 0, 2).reshape(T, C * F)
    d = p["out_w"].shape[0]
    return _linear(h, p["out_w"], p["out_b"]) * math.sqrt(d)


def _pe(T, d, device):
    """PE(r) for r = −(T−1) … T−1, row r + T − 1."""
    r = np.arange(-(T - 1), T, dtype=np.float64)[:, None]
    w = 10000.0 ** (-np.arange(0, d, 2, dtype=np.float64) / d)
    pe = np.zeros((2 * T - 1, d))
    pe[:, 0::2] = np.sin(r * w)
    pe[:, 1::2] = np.cos(r * w)
    return torch.from_numpy(pe).float().to(device)


def _ffn(x, p, pre):
    h = _ln(x, p[f"{pre}_ln_g"], p[f"{pre}_ln_b"])
    h = _swish(_linear(h, p[f"{pre}_w1"], p[f"{pre}_b1"]))
    return _linear(h, p[f"{pre}_w2"], p[f"{pre}_b2"])


def _mhsa(x, p):
    T, d = x.shape
    H = p["att_u"].shape[0]
    dk = d // H
    h = _ln(x, p["att_ln_g"], p["att_ln_b"])
    w, b = p["att_wqkv"], p["att_bqkv"]
    q, k, v = (_linear(h, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
               .reshape(T, H, dk).transpose(0, 1) for i in range(3))
    pos = _linear(_pe(T, d, x.device), p["att_wpos"])
    pos = pos.reshape(2 * T - 1, H, dk).transpose(0, 1)   # [H, 2T−1, dk]
    ac = torch.matmul(q + p["att_u"][:, None], k.transpose(1, 2))
    bd_all = torch.matmul(q + p["att_v"][:, None], pos.transpose(1, 2))
    i = torch.arange(T, device=x.device)
    rel = (i[:, None] - i[None, :]) + (T - 1)            # row of p_{i−j}
    bd = torch.gather(bd_all, 2, rel[None].expand(H, T, T))
    att = torch.softmax((ac + bd) / math.sqrt(dk), dim=-1)
    o = torch.matmul(att, v).transpose(0, 1).reshape(T, d)
    return _linear(o, p["att_wo"], p["att_bo"])


def _conv(x, p):
    T, d = x.shape
    h = _ln(x, p["conv_ln_g"], p["conv_ln_b"])
    h = _linear(h, p["conv_pw1_w"], p["conv_pw1_b"])
    h = h[:, :d] * torch.sigmoid(h[:, d:])
    w = p["conv_dw_w"]                                    # [d, K]
    K = w.shape[1]
    left = (K - 1) // 2
    hp = torch.cat([h.new_zeros((left, d)), h,
                    h.new_zeros((K - 1 - left, d))])
    y = p["conv_dw_b"].expand(T, d).clone()
    for t in range(K):
        y = y + hp[t:t + T] * w[:, t]
    y = (y - p["bn_mean"]) / torch.sqrt(p["bn_var"] + EPS) * p["bn_g"] \
        + p["bn_b"]
    return _linear(_swish(y), p["conv_pw2_w"], p["conv_pw2_b"])


def _block(x, p):
    x = x + 0.5 * _ffn(x, p, "ff1")
    x = x + _mhsa(x, p)
    x = x + _conv(x, p)
    x = x + 0.5 * _ffn(x, p, "ff2")
    return _ln(x, p["out_ln_g"], p["out_ln_b"])


def forward(layers, feats: torch.Tensor) -> torch.Tensor:
    """feats f32[T, F] (one utterance's fbank frames) → log-likelihoods
    f32[T', V].  Sets both TF32 switches off first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = feats.float()
    for kind, p in layers:
        if kind == "conv2d_subsample":
            x = _subsample(x, p)
        elif kind == "conformer":
            x = _block(x, p)
        elif kind == "affine":
            x = _linear(x, p["weight"], p["bias"])
        elif kind == "softmax":
            x = torch.log(torch.softmax(x, dim=-1))
        elif kind == "prior":
            x = x - p["log_priors"]
        else:
            raise ValueError(f"no reference for layer {kind!r}")
    return x
