"""The control of ``correct``: the plain reference put in the program's
place, one precision below the configuration's, judged by the same
comparison the benchmark's runs use.  It must come out not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For a cell with an AM (float32, TF32 off) the control computes fbank and
the AM with every product's operands rounded to TF32, and finds each
utterance's best path by an exact Viterbi over those log-likelihoods; for
``tlg2m`` (float32 costs, no product) the exact Viterbi rounds every cost
it forms to bfloat16.  The utterances or rows are the ones the cell's run
judges at the cell's own size: for a serving cell a sample drawn from
the seed of the utterances the window should finish, with the longest;
offline the cell's sampled rows of the pool's batches (``--rows`` caps
the rows a batch).  Prints
one JSON line a seed: each compared number, its limit, and ``correct``.
The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def control_numbers(ctx, rows_cap: int = 4) -> dict:
    """The compared numbers of the control on ``ctx``'s cell and seed."""
    import torch
    from benchmark import graphs, harness, inputs
    from benchmark.reference import am as ref_am, fbank as ref_fbank, \
        graph as ref_graph
    from benchmark.traffic.loadgen import lengths
    cfg, p, dev, seed = ctx.cell.config, ctx.params, ctx.device, ctx.seed
    kind = ctx.cell.workload["kind"]
    spec = cfg["graph"] if kind == "offline_search" else \
        {**cfg["graph"], "seed": seed}
    g = graphs.make_graph(spec, harness.CACHE, harness.log)
    idx = ref_graph.ArcIndex(g)
    out = {}
    worst_am, worst_cost, faults = 0.0, 0.0, 0
    answered = []

    def judge(ll_ref, ll_side, precision):
        nonlocal worst_am, worst_cost, faults
        if ll_side is not None:
            worst_am = max(worst_am, float(np.abs(
                ll_side.double().cpu().numpy() - ll_ref).max()))
        src = ll_side if ll_side is not None else \
            torch.from_numpy(ll_ref).float().to(dev)
        arcs, cost, reached = ref_graph.viterbi(idx, src, precision)
        words = [a[3] for a in arcs if a[3] != 0]
        bad, gap, total = ref_graph.judge_path(idx, arcs, len(ll_ref),
                                               ll_ref, words, cost, reached)
        faults += bool(bad)
        worst_cost = max(worst_cost, gap)
        if not bad:
            answered.append((ll_ref, total, reached))

    if kind == "offline_search":
        thresh = math.log(p["blank_prob"])
        for i in range(p["pool"]):
            raw = inputs.ctc_posteriors(g.lexicon, g.num_phones, p["batch"],
                                        p["frames"], seed, i)
            for b in range(min(rows_cap, p["batch"])):
                keep = np.flatnonzero(~(raw[b, :, 0] > np.float32(thresh)))
                judge(raw[b, keep].astype(np.float64), None, "bf16")
        out["cost_err"] = worst_cost
    else:
        weights = [(k, w) for k, _, _, _, w in
                   inputs.am_weights(cfg["am"], seed, dev)]
        nb, skip = cfg["fbank"]["num_bins"], cfg["am"]["skip"]
        if kind == "serve":
            lens = lengths({"params": p, "seed": seed})
            cand = np.arange(p["clients"])
            rng = np.random.default_rng([seed, 5])
            pick = set(rng.choice(cand, min(p["sample_utts"], len(cand)),
                                  replace=False).tolist())
            pick.add(int(cand[np.argmax(lens[cand])]))
            waves = [torch.from_numpy(inputs.wave(
                seed, u, float(lens[u])).astype(np.float32))[None].to(dev)
                for u in sorted(pick)]
            first = True
        else:
            rng = np.random.default_rng([seed, 6])
            waves = []
            for i in range(p["pool"]):
                rows = np.sort(rng.choice(p["batch"], min(p["sample_rows"],
                               p["batch"]), replace=False))[:rows_cap]
                w = inputs.wave_batch(seed, i, p["batch"], p["wave_s"], dev)
                waves += [w[r][None] for r in rows.tolist()]
            first = False
        for w in waves:
            with torch.no_grad():
                feats = ref_fbank.fbank(w, nb)
                ll = ref_am.forward(weights, feats, skip=skip,
                                    splice_first=first)[0]
                low = ref_am.forward(weights, feats, skip=skip,
                                     splice_first=first,
                                     precision="tf32")[0]
            judge(ll.double().cpu().numpy(), low, "fp32")
        out["am_err"] = worst_am
        out["cost_err"] = worst_cost
    out["path_faults"] = faults
    s = cfg["search"]
    prune = {"search_gap": None,
             "beam_gap": (s["beam"], min(s["beam_width"], s["max_active"]),
                          s["min_active"])}
    for name in prune.keys() & ctx.limits.keys():
        out[name] = ref_graph.search_gap(idx, answered, dev, prune[name])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", type=int, default=4)
    args = ap.parse_args(argv)
    import time
    import torch
    from benchmark import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = harness.manifest()["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(harness.cell(args.workload), seed, seconds,
                              False, torch.device("cuda"), time.monotonic())
        nums = control_numbers(ctx, args.rows)
        checks = {k: (v, ctx.limits[k]) for k, v in nums.items()}
        print(json.dumps({"seed": seed, "correct": harness.correct(checks),
                          "checks": harness.check_lines(checks)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
