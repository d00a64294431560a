"""The flagship projected-LSTM AM, plainly: splice +-1 (edge frames
repeated), affine, LSTMP layers with diagonal peepholes (gates G, I, F, O;
the recurrence over the projection), affine, softmax, log, minus the log
prior.  Weights are the benchmark's (``benchmark/inputs.py:am_weights``),
drawn again from the seed, never read from the program.

``precision`` "fp32" is the configuration's; "tf32" is the control's:
every matrix product's operands rounded to TF32's 10-bit mantissa first,
products summed in float32, as a tensor core runs them with TF32 on."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (13 low mantissa bits
    dropped, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(precision):
    if precision == "fp32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: torch.matmul(tf32(a), tf32(b))
    raise ValueError(precision)


def splice(x: torch.Tensor, offsets) -> torch.Tensor:
    T = x.shape[1]
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.tensor(list(offsets), device=x.device)[None, :]
           ).clamp(0, T - 1)
    return x[:, idx, :].reshape(x.shape[0], T, -1)


def forward(layers, feats: torch.Tensor, *, skip: int, splice_first: bool,
            precision: str = "fp32") -> torch.Tensor:
    """feats f32[B, T, D] (fbank) -> log-likelihoods f32[B, T', V].

    ``splice_first``: splice, then keep every (skip+1)-th frame from frame
    0 (the streaming front end's order); otherwise keep every (skip+1)-th
    frame, then splice those (``am_forward`` over a whole utterance, the
    offline pipeline's order)."""
    mm = _mm(precision)
    x = feats
    for kind, p in layers:
        if kind == "splice":
            if splice_first:
                x = splice(x, p["offsets"])[:, ::skip + 1]
            else:
                x = splice(x[:, ::skip + 1], p["offsets"])
        elif kind == "affine":
            x = mm(x, p["weight"].t()) + p["bias"]
        elif kind == "lstm_projected":
            H = p["w_r_m"].shape[1]
            B = x.shape[0]
            gx = mm(x, p["w_gifo_x"].t()) + p["bias"]
            c = x.new_zeros((B, H))
            r = x.new_zeros((B, p["w_r_m"].shape[0]))
            ys = []
            for t in range(x.shape[1]):
                g = gx[:, t] + mm(r, p["w_gifo_r"].t())
                gg, gi, gf, go = g.split(H, dim=1)
                i = torch.sigmoid(gi + p["phole_i"] * c)
                f = torch.sigmoid(gf + p["phole_f"] * c)
                c = i * torch.tanh(gg) + f * c
                o = torch.sigmoid(go + p["phole_o"] * c)
                r = mm(o * torch.tanh(c), p["w_r_m"].t())
                ys.append(r)
            x = torch.stack(ys, dim=1)
        elif kind == "softmax":
            x = torch.log(torch.softmax(x, dim=-1))
        elif kind == "prior":
            x = x - p["log_priors"]
        else:
            raise ValueError(f"no reference for layer {kind!r}")
    return x
