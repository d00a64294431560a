"""Offline batch transcription of utterances of many lengths, sorted by
length into padded batches, through a full-context AM: waves ->
``frontend/fbank.py:compute_fbank`` -> the AM through ``GraphedAm`` with
each row's fbank frames (the AM subsamples inside itself and returns each
row's output frames) -> ``TorchBeamSearch.advance`` with the frame mask
those output lengths make -> ``traceback`` -> words.

Set-up: the AM from the seed (first: a program without one of its layer
kinds stops here, before the graph is built), the graph from the seed,
the search, a pool of ``utterances`` lengths (``inputs.
utterance_lengths``: log-normal, clipped, stratified) sorted and cut
into batches of ``batch`` rows, each a wave batch of seeded noise drawn
on the device and zeroed past each row's length, and every batch of the
pool run once outside the window (each padded length is its own AM
capture).  ``offline_audio_s_per_s`` counts each batch's real audio, not
its padding.

Judged: ``sample_rows`` rows of each batch's first run in the window,
drawn from the seed, always with its shortest and its longest: the
reference computes each row alone at its own length (its fbank and AM,
``reference/conformer.py``); ``am_err`` over the row's real frames, its
path, words and cost, its output length against the rule T' = ((T − 1)
// 2 − 1) // 2 (a wrong one is a path fault), and ``beam_gap`` as
``offline_pipeline`` judges it."""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import conformer, graphs, harness, inputs
from benchmark.harness import Outcome, log
from benchmark.traffic import _offline
from benchmark.traffic.offline_search import device_fst

SAMPLE_RATE = 16000


def fbank_frames(n: int) -> int:
    """Fbank frames of ``n`` samples (25-ms windows every 10 ms, whole
    windows only)."""
    return 0 if n < 400 else 1 + (n - 400) // 160


def pool_rows(p: dict, seed: int) -> list:
    """The pool's batches: each an array of its rows' samples, shortest
    first (the same lengths for every seed)."""
    lp = p["length"]
    secs = np.sort(inputs.utterance_lengths(
        p["utterances"], seed, lp["median_s"], lp["sigma"], lp["min_s"],
        lp["max_s"]))
    n = (secs * SAMPLE_RATE).astype(np.int64)
    return [n[i:i + p["batch"]] for i in range(0, len(n), p["batch"])]


def wave_rows(seed: int, i: int, samples: np.ndarray, device):
    """Batch ``i``'s waves f32[B, max samples]: seeded noise at 1000 rms
    (as ``inputs.wave_batch``), zero past each row's samples."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed * 64 + 32 + i)
    w = torch.randn((len(samples), int(samples.max())), generator=gen,
                    device=device) * 1000.0
    n = torch.from_numpy(samples).to(device)
    return w.masked_fill(torch.arange(w.shape[1], device=device)[None, :]
                         >= n[:, None], 0.0)


def counters():
    """The program's AM counters (``models/nnet.py``), or None where the
    program has none."""
    from asr_decoder_tpu_torch.models import nnet
    got = [getattr(nnet, k, None) for k in
           ("frames_out", "frames_real", "attn_pairs")]
    return None if None in got else got


def warm_profiler() -> None:
    """Start and stop the device profiler once in set-up, so that its
    start inside the window is not its first (which takes seconds once
    the AM's and the search's graphs exist)."""
    prof = harness.Profiler()
    prof.start()
    prof.stop()


def run(ctx) -> Outcome:
    import torch
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.frontend.fbank import (FbankConfig,
                                                      compute_fbank)
    from asr_decoder_tpu_torch.models.nnet import GraphedAm
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    nnet = inputs.port_nnet(conformer.weights(cfg["am"], ctx.seed, dev), dev)
    am = GraphedAm(nnet.layers)
    g = graphs.make_graph({**cfg["graph"], "seed": ctx.seed}, harness.CACHE,
                          log)
    fst, dfst = device_fst(g, cfg, harness.CACHE)
    search = TorchBeamSearch(dfst, g.ilabel2pdf,
                             DecoderConfig(**cfg["search"]), device=dev)
    fb = FbankConfig(**cfg["fbank"])
    batches = pool_rows(p, ctx.seed)
    npool = len(batches)
    pool = [wave_rows(ctx.seed, i, n, dev) for i, n in enumerate(batches)]
    flens = [np.array([fbank_frames(int(x)) for x in n]) for n in batches]
    audio = [float(n.sum()) / SAMPLE_RATE for n in batches]
    B = p["batch"]
    rng = np.random.default_rng([ctx.seed, 6])
    rows = [np.sort(np.r_[0, len(n) - 1, 1 + rng.choice(
        len(n) - 2, p["sample_rows"] - 2, replace=False)])
        for n in batches]
    am_state = nnet.init_state(B, dev)
    if ctx.trace and dev.type == "cuda":
        from asr_decoder_tpu_torch.ops import gather
        gather.shapes = set()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    kept, steps, am_steps = {}, [], []
    spans = ctx.spans

    def one_batch(i, first):
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = compute_fbank(fb, pool[i])
            if ctx.trace:
                sync()
            ta = time.perf_counter()
            c0 = counters()
            ll, _, out_len = am(feats, am_state, flens[i])
            c1 = counters()
            if ctx.trace:
                sync()
        t1 = time.perf_counter()
        mask = np.arange(ll.shape[1])[None, :] < out_len[:, None]
        state, init_log = search.init_state(len(out_len))
        state, logs = search.advance(state, ll, mask)
        sync()
        t2 = time.perf_counter()
        results = search.traceback(state, init_log, logs, fst)
        t3 = time.perf_counter()
        if ctx.trace:
            spans.add("fbank", t0, ta)
            spans.add("am", ta, t1)
            spans.add("search", t1, t2)
            spans.add("traceback", t2, t3)
            live = int((logs.tok_state >= 0).sum())
            steps.append((t0, t3, t1, t2, int(ll.shape[1]), live))
            am_steps.append((ta, t1, None if c0 is None else
                             [b - a for a, b in zip(c0, c1)]))
        if first:
            r = torch.from_numpy(rows[i]).to(dev)
            kept[i] = (ll[r].cpu().numpy(), out_len[rows[i]],
                       [results[b] for b in rows[i]])

    for i in range(1, npool):                        # the loop warms 0
        one_batch(i, False)
    if ctx.trace and dev.type == "cuda":
        warm_profiler()
    out = _offline.loop(ctx, npool, one_batch, 0.0)
    setup_s = out["t0_monotonic"] - ctx.process_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    lanes = int(search.lanes) if search.lanes is not None else 0
    K, stages = search.beam_width, search.num_stages
    paths = {i: [inputs.port_path(fst, r["arc_ids"]) for r in res]
             for i, (_, _, res) in kept.items()}
    del search, dfst, fst, pool, am, nnet, am_state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {k: (v, ctx.limits[k]) for k, v in
              judge(ctx, g, kept, paths, rows, batches).items()}
    window = out["window"]
    served = sum(audio[k % npool] for k in range(out["batches"]))
    e2e = {"offline_audio_s_per_s": served / (window[1] - window[0]),
           "setup_s": setup_s}
    log(f"window: {out['batches']} batches ({served:.1f} audio-s) in "
        f"{window[1] - window[0]:.3f} s")
    data = {"window": window, "spans": spans, "steps": steps,
            "am_steps": am_steps, "batch": B, "vocab": cfg["am"]["num_pdfs"],
            "K": K, "stages": stages, "lanes": lanes, "config": cfg}
    if "trace" in out:
        data["trace"] = out["trace"]
        data["peaks"] = harness.PEAKS.get(torch.cuda.get_device_name(dev)
                                          if dev.type == "cuda" else "")
        from asr_decoder_tpu_torch.ops import gather
        data["gather_shapes"] = gather.shapes
    return Outcome(e2e, out["batches"], 0, checks, peak, data)


def judge(ctx, g, kept, paths, rows, batches) -> dict:
    """``am_err``, ``cost_err``, ``path_faults`` and ``beam_gap`` over the
    sampled rows, each row's reference computed alone."""
    import torch
    from benchmark.reference import conformer as ref_am, fbank as ref_fbank, \
        graph as ref_graph
    cfg, dev = ctx.cell.config, ctx.device
    idx = ref_graph.ArcIndex(g)
    weights = [(k, w) for k, _, _, _, w in
               conformer.weights(cfg["am"], ctx.seed, dev)]
    am_err, cost_err, faults = 0.0, 0.0, 0
    answered = []
    for i, (port_ll, port_len, results) in sorted(kept.items()):
        waves = wave_rows(ctx.seed, i, batches[i], dev)
        for j, b in enumerate(rows[i]):
            n = int(batches[i][b])
            with torch.no_grad():
                feats = ref_fbank.fbank(waves[b:b + 1, :n],
                                        cfg["fbank"]["num_bins"])[0]
                ll = ref_am.forward(weights, feats).double().cpu().numpy()
            T = len(ll)
            if port_len[j] != T or port_ll.shape[1] < T:
                log(f"batch {i} row {b}: {port_len[j]} output frames, "
                    f"the rule gives {T}")
                faults += 1
                continue
            am_err = max(am_err, float(np.abs(port_ll[j, :T] - ll).max()))
            res = results[j]
            bad, gap, total = ref_graph.judge_path(
                idx, paths[i][j], T, ll, res["words"], res["cost"],
                res["reached_final"])
            if bad:
                log(f"batch {i} row {b}: {'; '.join(bad)}")
                faults += 1
            else:
                answered.append((ll, total, res["reached_final"]))
            cost_err = max(cost_err, gap)
    if not kept:
        faults += 1
    s = cfg["search"]
    prune = (s["beam"], min(s["beam_width"], s["max_active"]),
             s["min_active"])
    gap = ref_graph.search_gap(idx, answered, dev, prune)
    log(f"am_err {am_err!r}, beam gap over {len(answered)} rows: {gap!r}")
    return {"am_err": am_err, "cost_err": cost_err, "path_faults": faults,
            "beam_gap": gap}
