"""What the benchmark makes from ``--seed`` and hands to the program and
the reference alike: the AM's weights (on the device, from one seeded
``torch.Generator`` there, in one draw), waves, CTC posteriors and the
graph (``benchmark/graphs``).  Nothing here imports the program; the ``port_*``
functions convert these inputs into the program's own types, importing
it when called.  Torch is imported inside the functions that need it, so
the load generator's process, which needs none, loads none."""

from __future__ import annotations

import statistics

import numpy as np

SCALE = 0.05          # weight scale of the port's flagship constructors


def am_layers(am: dict) -> list:
    """The flagship's layers as (kind, input dim, output dim, meta, {name:
    shape or None for zeros}) from the configuration's ``am`` block."""
    F, ctx, P, H = am["feat_dim"], am["context"], am["proj"], am["hidden"]
    V = am["num_pdfs"]
    offs = tuple(range(-ctx, ctx + 1))
    layers = [("splice", F, F * len(offs), offs, {}),
              ("affine", F * len(offs), P, (),
               {"weight": (P, F * len(offs)), "bias": None})]
    for _ in range(am["num_layers"]):
        layers.append(("lstm_projected", P, P, (), {
            "w_gifo_x": (4 * H, P), "w_gifo_r": (4 * H, P), "bias": None,
            "phole_i": (H,), "phole_f": (H,), "phole_o": (H,),
            "w_r_m": (P, H)}))
    layers += [("affine", P, V, (), {"weight": (V, P), "bias": None}),
               ("softmax", V, V, (), {}), ("prior", V, V, (), {})]
    return layers


def _bias_shape(kind, din, dout, H):
    return (dout,) if kind == "affine" else (4 * H,)


def am_weights(am: dict, seed: int, device) -> list:
    """[(kind, in, out, meta, {name: tensor})]: every random weight a slice
    of one ``randn`` draw on ``device`` (scale 0.05), biases zero, the
    prior uniform (log(1/V), as the port's ``make_prior`` of equal
    counts)."""
    import torch
    spec = am_layers(am)
    H = am["hidden"]
    sizes = [int(np.prod(s)) for _, _, _, _, p in spec for s in p.values()
             if s is not None]
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        flat = torch.randn(sum(sizes), generator=gen, device=device) * SCALE
    out, at = [], 0
    for kind, din, dout, meta, p in spec:
        params = {}
        for name, shape in p.items():
            if shape is None:
                params[name] = torch.zeros(_bias_shape(kind, din, dout, H),
                                           device=device)
            else:
                n = int(np.prod(shape))
                params[name] = flat[at:at + n].view(shape)
                at += n
        if kind == "prior":
            params["log_priors"] = torch.full(
                (dout,), float(np.float32(np.log(1.0 / dout + 1e-20))),
                device=device)
        if kind == "splice":
            params["offsets"] = meta
        out.append((kind, din, dout, meta, params))
    return out


def am_flops_per_frame(am: dict) -> int:
    """Multiply-adds x 2 of one frame through the AM's products."""
    fl = 0
    for kind, din, dout, _, p in am_layers(am):
        if kind in ("affine", "lstm_projected"):
            fl += sum(2 * int(np.prod(s)) for n, s in p.items()
                      if s is not None and len(s) == 2)
    return fl


def am_weight_bytes(am: dict) -> int:
    n = 0
    for kind, din, dout, _, p in am_layers(am):
        for name, s in p.items():
            n += 4 * int(np.prod(s if s is not None else
                                 _bias_shape(kind, din, dout, am["hidden"])))
    return n


# ----------------------------------------------------------------------
# traffic inputs
# ----------------------------------------------------------------------

def stratified(n: int, inv_cdf, seed: int, salt: int) -> np.ndarray:
    """``n`` draws that are the distribution's n quantiles at (i + 0.5)/n,
    in an order drawn from the seed: every seed gets the same set."""
    q = np.array([inv_cdf((i + 0.5) / n) for i in range(n)])
    return q[np.random.default_rng([seed, salt]).permutation(n)]


def utterance_lengths(n: int, seed: int, median_s: float, sigma: float,
                      lo: float, hi: float) -> np.ndarray:
    """Log-normal lengths (seconds), clipped, stratified."""
    nd = statistics.NormalDist()
    return np.clip(stratified(
        n, lambda p: median_s * np.exp(sigma * nd.inv_cdf(p)), seed, 1),
        lo, hi)


def wave(seed: int, uid: int, seconds: float, sample_rate: int = 16000
         ) -> np.ndarray:
    """Utterance ``uid``'s int16 audio: seeded noise at 4000 rms."""
    rng = np.random.default_rng([seed, 3, uid])
    n = int(round(seconds * sample_rate))
    return np.clip(rng.standard_normal(n) * 4000, -32768, 32767
                   ).astype(np.int16)


def wave_batch(seed: int, index: int, batch: int, seconds: float, device,
               sample_rate: int = 16000):
    """f32[batch, n] of noise at 1000 rms, drawn on ``device``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed * 64 + index)
    return torch.randn((batch, int(sample_rate * seconds)), generator=gen,
                       device=device) * 1000.0


def ctc_posteriors(lexicon: dict, num_phones: int, batch: int, frames: int,
                   seed: int, index: int) -> np.ndarray:
    """CTC-spiky log-posteriors f32[batch, frames, P + 1] over the TLG's
    phones (row 0 blank): word sequences from the lexicon rendered as one
    or two frames a phone with blanks between, template features plus
    noise, log-softmax scored (the recipe of the port's
    ``tools/bench.py:_tlg_posteriors``)."""
    rng = np.random.default_rng([seed, 4, index])
    t = rng.standard_normal((num_phones + 1, 24))
    templates = (t / np.linalg.norm(t, axis=1, keepdims=True)
                 ).astype(np.float32) * 2.5
    words = sorted(lexicon)
    lls = np.zeros((batch, frames, num_phones + 1), np.float32)
    for b in range(batch):
        rows = [0, 0]
        while len(rows) < frames:
            w = words[int(rng.integers(0, len(words)))]
            for q in lexicon[w]:
                rows.extend([q] * int(rng.integers(1, 3)))
                rows.extend([0] * int(rng.integers(0, 3)))
            rows.append(0)
        rows = rows[:frames]
        feats = templates[np.array(rows)] + \
            rng.standard_normal((frames, 24)).astype(np.float32) * 0.35
        sc = feats @ templates.T
        lls[b] = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
    return lls


# ----------------------------------------------------------------------
# into the program's types
# ----------------------------------------------------------------------

def port_nnet(weights: list, device):
    """The program's ``Nnet`` over the benchmark's weight tensors."""
    from asr_decoder_tpu_torch.models.layers import make_layer
    from asr_decoder_tpu_torch.models.nnet import Nnet
    layers = []
    for kind, din, dout, meta, params in weights:
        params = {k: v for k, v in params.items() if k != "offsets"}
        layers.append(make_layer(kind, din, dout, params or None, meta))
    return Nnet(layers).to(device)


def port_fst(g, olabel_anchor: str = "start"):
    """The program's ``StdFst`` of the raw graph (its own super-final
    rewrite)."""
    from asr_decoder_tpu_torch.fst.fst import StdFst
    fst = StdFst.from_final_weights(g.num_states, g.start, g.src, g.ilabel,
                                    g.olabel, g.weight, g.dst, g.finals)
    fst.olabel_anchor = olabel_anchor
    return fst


def port_path(fst, arc_ids) -> list:
    """The program's path as arc tuples (src, dst, ilabel, olabel,
    weight), read off its ``StdFst``."""
    ids = np.asarray(arc_ids, np.int64)
    if not len(ids):
        return []
    src = np.searchsorted(fst.state_offset, ids, side="right") - 1
    return [(int(s), int(d), int(i), int(o), float(w)) for s, d, i, o, w in
            zip(src, fst.arc_dst[ids], fst.arc_ilabel[ids],
                fst.arc_olabel[ids], fst.arc_weight[ids])]
