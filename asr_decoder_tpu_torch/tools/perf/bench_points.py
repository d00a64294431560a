"""Compare the relax engines on the three bench operating points
(headline 200k / production 2M / realistic trie CTC graph).

Port of ``tools/perf/bench_points.py``.  The variants are the two search
engines, ``sort`` (v2) and ``topk`` (v3); the JAX tool's ``fetch_impl``
xla/dma split is a TPU choice (the fetch kernel is held against its plain
version in ``chip_smoke.py``).  Each row times ``search.advance`` over the
point's batch (best of 3 after a warm-up, ended by a host read of the
costs) and reports ms/frame, stream-frames/s and audio-s/s — a frame is
30 ms of audio at the headline and production points (loglikes after 3x
subsampling) and 10 ms at the realistic one.

Usage: python -m asr_decoder_tpu_torch.tools.perf.bench_points
       [--device cuda|cpu] [headline|production|realistic ...]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from asr_decoder_tpu_torch.tools.perf._common import (device_arg,
                                                      device_line, force,
                                                      open_device)

POINTS = ("headline", "production", "realistic")
VARIANTS = (("sort", dict(relax_impl="sort")),
            ("topk", dict(relax_impl="topk")))


def time_search(search, st, ll, iters=3) -> float:
    force(search.advance(st, ll)[0])
    best = 1e30
    for _ in range(iters):
        t0 = time.perf_counter()
        force(search.advance(st, ll)[0])
        best = min(best, time.perf_counter() - t0)
    return best


def live_stats(search, st, ll) -> tuple[int, int]:
    stf, _ = search.advance(st, ll)
    live = torch.isfinite(stf.tok_cost).sum(dim=1).cpu().numpy()
    return int(live.mean()), int(live.max())


def _point(name: str, **size):
    """(DeviceFst, ilabel2pdf, loglikes [B,T,V], DecoderConfig kwargs,
    seconds of audio per frame) at the JAX tool's shapes; ``size``
    overrides states / words, B, T and K for a smoke run."""
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    rng = np.random.default_rng(1)
    if name == "headline":
        from asr_decoder_tpu_torch.fst.synthetic import random_hclg
        fst = random_hclg(np.random.default_rng(0),
                          num_states=size.get("states", 200_000),
                          num_ilabels=2048)
        i2p = np.concatenate([[0], np.arange(2048)]).astype(np.int32)
        dev = DeviceFst.build(fst, arc_lanes=8)
        B, T, K = size.get("B", 256), size.get("T", 88), size.get("K", 512)
        ll = (rng.standard_normal((B, T, 2048)) * 3).astype(np.float32)
        kw = dict(arc_lanes=8, min_active=16)
        frame_s = 0.03
    elif name == "production":
        from asr_decoder_tpu_torch.tools.perf.profile_production import \
            build_or_load_dev
        dev = build_or_load_dev(size.get("states", 2_000_000))
        i2p = np.concatenate([[0], np.arange(2048)]).astype(np.int32)
        B, T, K = size.get("B", 32), size.get("T", 88), size.get("K", 4096)
        ll = (rng.standard_normal((B, T, 2048)) * 3).astype(np.float32)
        kw = dict(arc_lanes=8, min_active=min(200, K))
        frame_s = 0.03
    elif name == "realistic":
        from asr_decoder_tpu_torch.eval.synth_task import SynthTask
        from asr_decoder_tpu_torch.fst.ctc_graph import build_ctc_decode_graph
        task = SynthTask(num_phones=40, num_words=size.get("words", 30_000),
                         feat_dim=24, seed=0)
        fst, i2p = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                          task.num_phones,
                                          share_prefixes=True)
        i2p = np.asarray(i2p, np.int32)
        dev = DeviceFst.build(fst, arc_lanes=16)
        B, T, K = size.get("B", 64), size.get("T", 160), size.get("K", 1024)
        rng3 = np.random.default_rng(7)
        ll = np.zeros((B, T, task.num_phones + 1), np.float32)
        for b in range(B):
            while True:
                _, _, feats = task.sample_utterance(rng3)
                if len(feats) <= T:
                    break
            sc = feats @ task.templates.T
            lp = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
            ll[b, :len(lp)] = lp
            ll[b, len(lp):] = lp[-1]
        kw = dict(arc_lanes=16, min_active=min(200, K))
        frame_s = 0.01
    else:
        raise ValueError(f"unknown point {name!r}; choose from {POINTS}")
    kw.update(beam=14.0, beam_width=K, max_active=K, eps_mode="closure")
    return dev, i2p, ll, kw, frame_s


def run_point(name: str, device: torch.device, **size) -> list[str]:
    """Time both engines at one point; prints and returns the rows."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    dev, i2p, ll_host, kw, frame_s = _point(name, **size)
    B, T = ll_host.shape[:2]
    ll = torch.from_numpy(ll_host).to(device)   # on the device once
    rows = []
    for label, extra in VARIANTS:
        try:
            search = TorchBeamSearch(dev, i2p, DecoderConfig(**kw, **extra),
                                     device=device)
        except ValueError as e:                  # the engine cannot run here
            rows.append(f"{name} {label}: FAIL {e}")
            print(rows[-1], flush=True)
            continue
        st, _ = search.init_state(B)
        lm, lx = live_stats(search, st, ll)
        dt = time_search(search, st, ll)
        rows.append(
            f"{name:11s} {label:5s} ({search.mode}) B={B} T={T} "
            f"K={search.beam_width} S={dev.num_states}: search "
            f"{dt * 1e3:9.1f} ms = {dt / T * 1e3:7.3f} ms/frame, "
            f"{B * T / dt:9.1f} stream-frames/s, "
            f"{B * T * frame_s / dt:8.1f} audio-s/s ({device.type})   "
            f"live mean={lm} max={lx}")
        print(rows[-1], flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("points", nargs="*", default=["realistic", "headline"],
                    choices=POINTS)
    args = ap.parse_args(argv)
    device = open_device(args.device)
    print(device_line(device), flush=True)
    for p in args.points:
        run_point(p, device)


if __name__ == "__main__":
    main()
