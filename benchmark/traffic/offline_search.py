"""Offline decoding from stored acoustic scores (as Kaldi's mapped
decoders do): batches of CTC posteriors -> ``models/nnet.py:
pack_nonblank_frames`` (blank frames out) -> ``TorchBeamSearch.advance``
-> ``traceback`` -> words.  The AM is bypassed.

Set-up: the configuration's graph (built once per checkout and cached in
``build/benchmark/``, as the program's ``DeviceFst`` with its epsilon
closure is, through the program's own ``save``/``load``), the search, and
a pool of batches of posteriors drawn from the seed.

Judged: every row of the window's first pass over the pool: the packing
(each row's kept frames, exactly, against the reference's own rule) and
the path, its words and its cost (``reference/graph.py``), the cost
against the float64 sum over the raw posteriors; and, for ``gap_rows``
of those rows drawn from the seed and the row with most kept frames, the
gap between that cost and the least cost of any path of the graph over
the same frames (``search_gap``)."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from benchmark import graphs, harness, inputs
from benchmark.harness import Outcome, log
from benchmark.traffic import _offline


def device_fst(g, cfg, cache):
    """The program's ``DeviceFst`` of the graph, from the checkout's cache
    when a run has built it."""
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    fst = inputs.port_fst(g, cfg.get("olabel_anchor", "start"))
    key = "_".join(f"{k}{v}" for k, v in sorted(cfg["graph"].get(
        "lm", {}).items()))
    path = cache / f"devfst_{cfg['graph']['kind']}_{key}_" \
        f"l{cfg['search']['arc_lanes']}.npz"
    if cfg["graph"]["kind"] == "tlg" and path.exists():
        return fst, DeviceFst.load(str(path))
    dev = DeviceFst.build(fst, arc_lanes=cfg["search"]["arc_lanes"])
    dev.build_closure()
    if cfg["graph"]["kind"] == "tlg":
        tmp = path.with_name(path.name + ".tmp.npz")
        dev.save(str(tmp))
        tmp.replace(path)
    return fst, dev


def run(ctx) -> Outcome:
    import torch
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    g = graphs.make_graph(cfg["graph"], harness.CACHE, log)
    fst, dfst = device_fst(g, cfg, harness.CACHE)
    search = TorchBeamSearch(dfst, g.ilabel2pdf,
                             DecoderConfig(**cfg["search"]), device=dev)
    B, T = p["batch"], p["frames"]
    pool = [torch.from_numpy(inputs.ctc_posteriors(
        g.lexicon, g.num_phones, B, T, ctx.seed, i)).to(dev)
        for i in range(p["pool"])]
    thresh = math.log(p["blank_prob"])
    if ctx.trace and dev.type == "cuda":
        from asr_decoder_tpu_torch.ops import gather
        gather.shapes = set()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    kept, steps = {}, []
    spans = ctx.spans

    def one_batch(i, first):
        t0 = time.perf_counter()
        packed, pmask = pack_nonblank_frames(pool[i], 0, thresh=thresh)
        state, init_log = search.init_state(B)
        t1 = time.perf_counter()
        state, logs = search.advance(state, packed, pmask)
        sync()
        t2 = time.perf_counter()
        results = search.traceback(state, init_log, logs, fst)
        t3 = time.perf_counter()
        if ctx.trace:
            spans.add("pack", t0, t1)
            spans.add("search", t1, t2)
            spans.add("traceback", t2, t3)
            live = int((logs.tok_state >= 0).sum())
            steps.append((t0, t3, t1, t2, int(packed.shape[1]), live))
        if first:
            kept[i] = (pmask.sum(dim=1).cpu().numpy(),
                       packed.cpu().numpy(), results)

    out = _offline.loop(ctx, p["pool"], one_batch, B * T * p["frame_s"])
    setup_s = out["t0_monotonic"] - ctx.process_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    lanes = int(search.lanes) if search.lanes is not None else 0
    K, stages = search.beam_width, search.num_stages
    paths = {i: [inputs.port_path(fst, r["arc_ids"]) for r in res]
             for i, (_, _, res) in kept.items()}
    del search, dfst, fst, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {k: (v, ctx.limits[k])
              for k, v in judge(ctx, g, kept, paths, thresh).items()}
    window = out["window"]
    e2e = {"offline_audio_s_per_s": out["audio_s"] / (window[1] - window[0]),
           "setup_s": setup_s}
    log(f"window: {out['batches']} batches of {B} x {T} frames in "
        f"{window[1] - window[0]:.3f} s")
    data = {"window": window, "spans": spans, "steps": steps,
            "batch": B, "frames": T, "vocab": g.num_phones + 1, "K": K,
            "stages": stages, "lanes": lanes, "config": cfg}
    if "trace" in out:
        data["trace"] = out["trace"]
        data["peaks"] = harness.PEAKS.get(torch.cuda.get_device_name(dev)
                                          if dev.type == "cuda" else "")
        from asr_decoder_tpu_torch.ops import gather
        data["gather_shapes"] = gather.shapes
    return Outcome(e2e, out["batches"], 0, checks, peak, data)


def judge(ctx, g, kept, paths, thresh) -> dict:
    """``pack_faults``: rows whose packing differs from the reference's;
    ``path_faults``: rows whose path or answer is wrong; ``cost_err``: the
    largest relative gap of a row's cost; ``search_gap``: the largest
    relative gap of a sampled row's cost above the exact best."""
    from benchmark.reference import graph as ref_graph
    p = ctx.params
    idx = ref_graph.ArcIndex(g)
    pack_faults = path_faults = 0
    cost_err = 0.0
    answered = []                   # (batch, row, frames, cost, final)
    for i, (counts, packed, results) in sorted(kept.items()):
        raw = inputs.ctc_posteriors(g.lexicon, g.num_phones, p["batch"],
                                    p["frames"], ctx.seed, i)
        for b, res in enumerate(results):
            keep = np.flatnonzero(~(raw[b, :, 0] > np.float32(thresh)))
            if counts[b] != len(keep) or not np.array_equal(
                    packed[b, :len(keep)], raw[b, keep]):
                pack_faults += 1
                continue
            bad, gap, total = ref_graph.judge_path(
                idx, paths[i][b], len(keep), raw[b, keep].astype(np.float64),
                res["words"], res["cost"], res["reached_final"])
            if bad:
                log(f"batch {i} row {b}: {'; '.join(bad)}")
                path_faults += 1
            else:
                answered.append((i, b, len(keep), total,
                                 res["reached_final"]))
            cost_err = max(cost_err, gap)
    if not kept:
        path_faults += 1
    log(f"judged {sum(len(r) for _, _, r in kept.values())} rows")
    rows = []
    if answered:
        rng = np.random.default_rng([ctx.seed, 7])
        pick = set(rng.choice(len(answered), min(p["gap_rows"],
                              len(answered)), replace=False).tolist())
        pick.add(max(range(len(answered)), key=lambda k: answered[k][2]))
        for k in sorted(pick):
            i, b, _, total, reached = answered[k]
            raw = inputs.ctc_posteriors(g.lexicon, g.num_phones, p["batch"],
                                        p["frames"], ctx.seed, i)[b]
            rows.append((raw[~(raw[:, 0] > np.float32(thresh))], total,
                         reached))
    gap = ref_graph.search_gap(idx, rows, ctx.device)
    log(f"search gap over {len(rows)} rows: {gap!r}")
    return {"pack_faults": pack_faults, "path_faults": path_faults,
            "cost_err": cost_err, "search_gap": gap}
