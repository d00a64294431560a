"""The offline batch pipeline that bypasses the server: waves ->
``frontend/fbank.py:compute_fbank`` -> the AM through ``GraphedAm``
(frame subsampling inside ``am_forward``: every third fbank frame, then
the splice) -> ``TorchBeamSearch.advance`` -> ``traceback`` -> words.

Set-up: the graph from the seed, the AM's weights from the seed, the
search, a pool of wave batches drawn on the device, and one batch run
outside the window.

Judged: a sample of rows of each batch's first run in the window, drawn
from the seed: their log-likelihoods against the reference's fbank and AM
over the same waves, their paths, words and costs
(``reference/graph.py``), and the gap of their costs above those of a
plain beam search of the configuration's beam and width over the
reference's log-likelihoods (``beam_gap``: with flat random-AM scores
the width cuts the exact best path away in every row, by as much as each
seed's graph makes it, so only a search that prunes as the configuration
states is a yardstick here)."""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import graphs, harness, inputs
from benchmark.harness import Outcome, log
from benchmark.traffic import _offline
from benchmark.traffic.offline_search import device_fst


def run(ctx) -> Outcome:
    import torch
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.frontend.fbank import (FbankConfig,
                                                      compute_fbank)
    from asr_decoder_tpu_torch.models.nnet import GraphedAm
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    g = graphs.make_graph({**cfg["graph"], "seed": ctx.seed}, harness.CACHE,
                          log)
    fst, dfst = device_fst(g, cfg, harness.CACHE)
    search = TorchBeamSearch(dfst, g.ilabel2pdf,
                             DecoderConfig(**cfg["search"]), device=dev)
    nnet = inputs.port_nnet(inputs.am_weights(cfg["am"], ctx.seed, dev),
                            dev)
    am = GraphedAm(nnet.layers)
    fb = FbankConfig(**cfg["fbank"])
    B, secs, skip = p["batch"], p["wave_s"], cfg["am"]["skip"]
    am_state = nnet.init_state(B, dev)
    pool = [inputs.wave_batch(ctx.seed, i, B, secs, dev)
            for i in range(p["pool"])]
    rng = np.random.default_rng([ctx.seed, 6])
    rows = [np.sort(rng.choice(B, min(p["sample_rows"], B), replace=False))
            for _ in range(p["pool"])]
    if ctx.trace and dev.type == "cuda":
        from asr_decoder_tpu_torch.ops import gather
        gather.shapes = set()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    kept, steps = {}, []
    spans = ctx.spans

    def one_batch(i, first):
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = compute_fbank(fb, pool[i])
            ll, _ = am(feats, am_state, skip=skip)
        state, init_log = search.init_state(B)
        if ctx.trace:
            sync()
        t1 = time.perf_counter()
        state, logs = search.advance(state, ll)
        sync()
        t2 = time.perf_counter()
        results = search.traceback(state, init_log, logs, fst)
        t3 = time.perf_counter()
        if ctx.trace:
            spans.add("am", t0, t1)
            spans.add("search", t1, t2)
            spans.add("traceback", t2, t3)
            live = int((logs.tok_state >= 0).sum())
            steps.append((t0, t3, t1, t2, int(ll.shape[1]), live))
        if first:
            r = torch.from_numpy(rows[i]).to(dev)
            kept[i] = (ll[r].cpu().numpy(), [results[b] for b in rows[i]])

    out = _offline.loop(ctx, p["pool"], one_batch, B * secs)
    setup_s = out["t0_monotonic"] - ctx.process_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    lanes = int(search.lanes) if search.lanes is not None else 0
    K, stages = search.beam_width, search.num_stages
    paths = {i: [inputs.port_path(fst, r["arc_ids"]) for r in res]
             for i, (_, res) in kept.items()}
    del search, dfst, fst, pool, am, nnet, am_state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {k: (v, ctx.limits[k]) for k, v in
              judge(ctx, g, kept, paths, rows).items()}
    window = out["window"]
    e2e = {"offline_audio_s_per_s": out["audio_s"] / (window[1] - window[0]),
           "setup_s": setup_s}
    log(f"window: {out['batches']} batches of {B} x {secs} s in "
        f"{window[1] - window[0]:.3f} s")
    data = {"window": window, "spans": spans, "steps": steps, "batch": B,
            "vocab": cfg["am"]["num_pdfs"], "K": K, "stages": stages,
            "lanes": lanes, "config": cfg}
    if "trace" in out:
        data["trace"] = out["trace"]
        data["peaks"] = harness.PEAKS.get(torch.cuda.get_device_name(dev)
                                          if dev.type == "cuda" else "")
        from asr_decoder_tpu_torch.ops import gather
        data["gather_shapes"] = gather.shapes
    return Outcome(e2e, out["batches"], 0, checks, peak, data)


def judge(ctx, g, kept, paths, rows) -> dict:
    """``am_err``, ``cost_err``, ``path_faults`` and ``beam_gap`` over the
    sampled rows (as ``traffic/serve.py:judge``)."""
    import torch
    from benchmark.reference import am as ref_am, fbank as ref_fbank, \
        graph as ref_graph
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    idx = ref_graph.ArcIndex(g)
    weights = [(k, w) for k, _, _, _, w in
               inputs.am_weights(cfg["am"], ctx.seed, dev)]
    am_err, cost_err, faults = 0.0, 0.0, 0
    answered = []
    for i, (port_ll, results) in sorted(kept.items()):
        with torch.no_grad():
            waves = inputs.wave_batch(ctx.seed, i, p["batch"], p["wave_s"],
                                      dev)[torch.from_numpy(rows[i]).to(dev)]
            feats = ref_fbank.fbank(waves, cfg["fbank"]["num_bins"])
            ll = ref_am.forward(weights, feats, skip=cfg["am"]["skip"],
                                splice_first=False).double().cpu().numpy()
        if port_ll.shape != ll.shape:
            faults += len(results)
            continue
        am_err = max(am_err, float(np.abs(port_ll - ll).max()))
        for j, res in enumerate(results):
            bad, gap, total = ref_graph.judge_path(
                idx, paths[i][j], ll.shape[1], ll[j], res["words"],
                res["cost"], res["reached_final"])
            if bad:
                log(f"batch {i} row {rows[i][j]}: {'; '.join(bad)}")
                faults += 1
            else:
                answered.append((ll[j], total, res["reached_final"]))
            cost_err = max(cost_err, gap)
    if not kept:
        faults += 1
    s = cfg["search"]
    prune = (s["beam"], min(s["beam_width"], s["max_active"]),
             s["min_active"])
    gap = ref_graph.search_gap(idx, answered, dev, prune)
    log(f"beam gap over {len(answered)} rows: {gap!r}")
    return {"am_err": am_err, "cost_err": cost_err, "path_faults": faults,
            "beam_gap": gap}
