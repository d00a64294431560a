"""The Conformer configuration's side of the benchmark: its weights, drawn
from ``--seed`` on the device for the program and the reference alike,
and the counts its per-layer metrics read (operations and bytes).
Nothing here imports the program.

Weights (``assumed.weights`` of ``configs/conformer_l.json``): one
``randn`` draw on the device, sliced in the order of each layer's
weights, then scaled so that no part of a block is trivial: products
(Linear, convolution, W_pos) at 1/√fan-in, the front end's output Linear
a further 1/√d (the ·√d after it leaves unit-scale frames), biases, u, v,
the batch norm's running means and β at 0.1, layer-norm and batch-norm
gains at 1 + 0.1·n, running variances exp(0.3·n); the head an affine at
1/√d with 0.1 biases, a uniform prior.

Counts, for the rows' real output frames (40 ms each): the front end
(two first-convolution rows, one second-convolution row and the output
Linear a frame), per block the two feed-forward modules, the q, k, v and
output projections, both pointwise convolutions and the depthwise one,
and the head; attention 8·d per query-key pair a block (the content
scores, the relative scores against ~2T' positions, the weighted sum of
values).  The positional projection (once a batch, ~0.1% of it) and
elementwise work are not counted, so the count is a lower bound of the
work."""

from __future__ import annotations

import math

import numpy as np


def _subsample_lengths(n):
    return max(((n - 1) // 2 - 1) // 2, 0)


def layer_specs(am: dict) -> list:
    """(kind, input dim, output dim, meta, {name: shape}) a layer, the
    weights in the program's blob order."""
    F, d, H = am["feat_dim"], am["d_model"], am["heads"]
    K, ffn, V = am["conv_kernel"], am["ffn_dim"], am["num_pdfs"]
    Fp = _subsample_lengths(F)
    front = {"conv1_w": (d, 1, 3, 3), "conv1_b": (d,),
             "conv2_w": (d, d, 3, 3), "conv2_b": (d,),
             "out_w": (d, d * Fp), "out_b": (d,)}

    def ff(p):
        return {f"{p}_ln_g": (d,), f"{p}_ln_b": (d,), f"{p}_w1": (ffn, d),
                f"{p}_b1": (ffn,), f"{p}_w2": (d, ffn), f"{p}_b2": (d,)}
    block = {**ff("ff1"), "att_ln_g": (d,), "att_ln_b": (d,),
             "att_wqkv": (3 * d, d), "att_bqkv": (3 * d,),
             "att_wpos": (d, d), "att_u": (H, d // H), "att_v": (H, d // H),
             "att_wo": (d, d), "att_bo": (d,),
             "conv_ln_g": (d,), "conv_ln_b": (d,),
             "conv_pw1_w": (2 * d, d), "conv_pw1_b": (2 * d,),
             "conv_dw_w": (d, K), "conv_dw_b": (d,),
             "bn_mean": (d,), "bn_var": (d,), "bn_g": (d,), "bn_b": (d,),
             "conv_pw2_w": (d, d), "conv_pw2_b": (d,),
             **ff("ff2"), "out_ln_g": (d,), "out_ln_b": (d,)}
    return ([("conv2d_subsample", F, d, (), front)]
            + [("conformer", d, d, (H, K, ffn), block)] * am["blocks"]
            + [("affine", d, V, (), {"weight": (V, d), "bias": (V,)}),
               ("softmax", V, V, (), {}), ("prior", V, V, (), {})])


def _scale(kind, name, shape, d):
    if name.endswith(("_ln_g", "bn_g")):
        return "gain"
    if name == "bn_var":
        return "var"
    if len(shape) >= 2 and name not in ("att_u", "att_v"):
        s = 1.0 / math.sqrt(int(np.prod(shape[1:])))
        return s / math.sqrt(d) if name == "out_w" else s
    return 0.1


def weights(am: dict, seed: int, device) -> list:
    """[(kind, in, out, meta, {name: tensor})], every weight a slice of one
    seeded draw on ``device`` (module docstring)."""
    import torch
    specs = layer_specs(am)
    total = sum(int(np.prod(s)) for *_, p in specs for s in p.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        flat = torch.randn(total, generator=gen, device=device)
    out, at = [], 0
    for kind, din, dout, meta, shapes in specs:
        params = {}
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            w = flat[at:at + n].view(shape)
            at += n
            s = _scale(kind, name, shape, am["d_model"])
            params[name] = (1.0 + 0.1 * w if s == "gain" else
                            torch.exp(0.3 * w) if s == "var" else w * s)
        if kind == "prior":
            params["log_priors"] = torch.full(
                (dout,), float(np.float32(np.log(1.0 / dout + 1e-20))),
                device=device)
        out.append((kind, din, dout, meta, params))
    return out


def weight_bytes(am: dict) -> int:
    return 4 * sum(int(np.prod(s)) for *_, p in layer_specs(am)
                   for s in p.values())


def frame_flops(am: dict) -> int:
    """FLOPs (2 x multiply-adds) a real output frame, attention's pairs
    aside."""
    F, d, K = am["feat_dim"], am["d_model"], am["conv_kernel"]
    ffn, V = am["ffn_dim"], am["num_pdfs"]
    F1 = (F - 1) // 2
    F2 = _subsample_lengths(F)
    front = 2 * (2 * 9 * d * F1) + 2 * 9 * d * d * F2 + 2 * d * F2 * d
    block = (2 * 2 * (2 * d * ffn)          # two feed-forward modules
             + 2 * 3 * d * d + 2 * d * d    # q, k, v and output
             + 2 * d * 2 * d + 2 * d * K + 2 * d * d)   # the conv module
    return front + am["blocks"] * block + 2 * d * V


def am_flops(am: dict, frames_real: int, attn_pairs: int) -> float:
    """The AM's FLOPs over rows with ``frames_real`` output frames in all
    and Σ T'² = ``attn_pairs``."""
    return (float(frames_real) * frame_flops(am)
            + 8.0 * am["d_model"] * am["blocks"] * float(attn_pairs))


def step_bytes(am: dict, frames_out: int, K: int, stages: int, live: int,
               lanes: int) -> float:
    """A batch's bytes as ``metrics/step_mfu.py`` counts them: the AM's
    weights once, each padded output frame's fbank input (4 frames) and
    log-likelihoods (written, read), the search's logs a row-frame, and
    the state records of the live tokens."""
    V = am["num_pdfs"]
    log_bytes = 4 * K * (2 * stages + 2)
    return (weight_bytes(am) + frames_out * (4 * (4 * am["feat_dim"] + 2 * V)
                                             + log_bytes)
            + live * lanes * 4)
