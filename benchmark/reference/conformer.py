"""The full-context Conformer AM, plainly (Gulati et al. 2020, arXiv:
2005.08100, Table 1; the benchmark's copy of the tests' reference
``tests/conformer_reference.py``, which lists the equations and each
departure from the paper): plain ``torch`` in float32 with TF32 off, one
utterance at its own length, no padding, batch, cache or graph.  Weights
are the benchmark's (``benchmark/conformer.py:weights``), drawn again
from the seed, never read from the program, as ``[(kind, {name:
tensor})]``.

``precision`` "fp32" is the configuration's; "tf32" is the control's:
every product's operands (the depthwise convolution's taps too) rounded
to TF32's 10-bit mantissa first, products summed in float32, as a tensor
core runs them with TF32 on (``reference/am.py:tf32``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.am import tf32

EPS = 1e-5


def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * g + b


def _mm(a, b, precision):
    if precision == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    if precision != "fp32":
        raise ValueError(precision)
    return torch.matmul(a, b)


def _linear(x, w, b=None, precision="fp32"):
    y = _mm(x, w.t(), precision)
    return y if b is None else y + b


def _swish(x):
    return x * torch.sigmoid(x)


def _conv3x3_s2(x, w, b, pr):
    """x f32[Cin, T, F] → f32[Cout, (T−1)//2, (F−1)//2]: each output the
    sum over its 3x3xCin input patch (an explicit patch matrix)."""
    cout = w.shape[0]
    patches = x.unfold(1, 3, 2).unfold(2, 3, 2)        # [Cin, T', F', 3, 3]
    cin, T, F = patches.shape[:3]
    cols = patches.permute(1, 2, 0, 3, 4).reshape(T * F, cin * 9)
    y = _mm(cols, w.reshape(cout, cin * 9).t(), pr) + b
    return y.t().reshape(cout, T, F)


def _subsample(x, p, pr):
    h = torch.relu(_conv3x3_s2(x[None], p["conv1_w"], p["conv1_b"], pr))
    h = torch.relu(_conv3x3_s2(h, p["conv2_w"], p["conv2_b"], pr))
    C, T, F = h.shape
    h = h.permute(1, 0, 2).reshape(T, C * F)
    d = p["out_w"].shape[0]
    return _linear(h, p["out_w"], p["out_b"], pr) * math.sqrt(d)


def _pe(T, d, device):
    """PE(r) for r = −(T−1) … T−1, row r + T − 1."""
    r = np.arange(-(T - 1), T, dtype=np.float64)[:, None]
    w = 10000.0 ** (-np.arange(0, d, 2, dtype=np.float64) / d)
    pe = np.zeros((2 * T - 1, d))
    pe[:, 0::2] = np.sin(r * w)
    pe[:, 1::2] = np.cos(r * w)
    return torch.from_numpy(pe).float().to(device)


def _ffn(x, p, pre, pr):
    h = _ln(x, p[f"{pre}_ln_g"], p[f"{pre}_ln_b"])
    h = _swish(_linear(h, p[f"{pre}_w1"], p[f"{pre}_b1"], pr))
    return _linear(h, p[f"{pre}_w2"], p[f"{pre}_b2"], pr)


def _mhsa(x, p, pr):
    T, d = x.shape
    H = p["att_u"].shape[0]
    dk = d // H
    h = _ln(x, p["att_ln_g"], p["att_ln_b"])
    w, b = p["att_wqkv"], p["att_bqkv"]
    q, k, v = (_linear(h, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d], pr)
               .reshape(T, H, dk).transpose(0, 1) for i in range(3))
    pos = _linear(_pe(T, d, x.device), p["att_wpos"], None, pr)
    pos = pos.reshape(2 * T - 1, H, dk).transpose(0, 1)   # [H, 2T−1, dk]
    ac = _mm(q + p["att_u"][:, None], k.transpose(1, 2), pr)
    bd_all = _mm(q + p["att_v"][:, None], pos.transpose(1, 2), pr)
    i = torch.arange(T, device=x.device)
    rel = (i[:, None] - i[None, :]) + (T - 1)            # row of p_{i−j}
    bd = torch.gather(bd_all, 2, rel[None].expand(H, T, T))
    att = torch.softmax((ac + bd) / math.sqrt(dk), dim=-1)
    o = _mm(att, v, pr).transpose(0, 1).reshape(T, d)
    return _linear(o, p["att_wo"], p["att_bo"], pr)


def _conv(x, p, pr):
    T, d = x.shape
    h = _ln(x, p["conv_ln_g"], p["conv_ln_b"])
    h = _linear(h, p["conv_pw1_w"], p["conv_pw1_b"], pr)
    h = h[:, :d] * torch.sigmoid(h[:, d:])
    w = p["conv_dw_w"]                                    # [d, K]
    if pr == "tf32":
        h, w = tf32(h), tf32(w)
    K = w.shape[1]
    left = (K - 1) // 2
    hp = torch.cat([h.new_zeros((left, d)), h,
                    h.new_zeros((K - 1 - left, d))])
    y = p["conv_dw_b"].expand(T, d).clone()
    for t in range(K):
        y = y + hp[t:t + T] * w[:, t]
    y = (y - p["bn_mean"]) / torch.sqrt(p["bn_var"] + EPS) * p["bn_g"] \
        + p["bn_b"]
    return _linear(_swish(y), p["conv_pw2_w"], p["conv_pw2_b"], pr)


def _block(x, p, pr):
    x = x + 0.5 * _ffn(x, p, "ff1", pr)
    x = x + _mhsa(x, p, pr)
    x = x + _conv(x, p, pr)
    x = x + 0.5 * _ffn(x, p, "ff2", pr)
    return _ln(x, p["out_ln_g"], p["out_ln_b"])


def forward(layers, feats: torch.Tensor, precision: str = "fp32"
            ) -> torch.Tensor:
    """feats f32[T, F] (one utterance's fbank frames) → log-likelihoods
    f32[T', V].  Sets both TF32 switches off first; ``precision`` "tf32"
    then rounds every product's operands to TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = feats.float()
    for kind, p in layers:
        if kind == "conv2d_subsample":
            x = _subsample(x, p, precision)
        elif kind == "conformer":
            x = _block(x, p, precision)
        elif kind == "affine":
            x = _linear(x, p["weight"], p["bias"], precision)
        elif kind == "softmax":
            x = torch.log(torch.softmax(x, dim=-1))
        elif kind == "prior":
            x = x - p["log_priors"]
        else:
            raise ValueError(f"no reference for layer {kind!r}")
    return x
