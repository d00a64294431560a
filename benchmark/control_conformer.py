"""The controls of ``correct`` in ``conformer_l.offline``, each judged by
the cell's own comparison (``traffic/offline_bucketed.py:judge``) at the
cell's size.  Each must come out not correct.

    python3 -m benchmark.control_conformer --seeds 1,2,3 [--rows 4]
    python3 -m benchmark.control_conformer --seeds 1 --width 256 [--seconds 6]

Without ``--width``: the plain reference one precision below the
configuration's (every product's operands rounded to TF32, ``reference/
conformer.py``) stands in for the program, and an exact Viterbi over its
log-likelihoods for the search, on the rows the cell judges (the first
``--rows`` sampled rows of each batch, the shortest and the longest among
them).  With ``--width K``: the cell itself runs (``run.run_cell``, the
window ``--seconds`` long, at least one pass of the pool) with the
program's search width cut to K (``beam_width`` and ``max_active``; its
``min_active`` at most K), while the judge's beam search keeps the
configuration's width.  Prints one JSON line a seed: each compared
number, its limit, and ``correct``.  The benchmark's own runs never run
it."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from unittest import mock

import numpy as np


def control_checks(ctx, rows_cap: int) -> dict:
    """The compared numbers ``{name: (value, limit)}`` of the TF32
    reference and an exact Viterbi in the program's place."""
    import torch
    from benchmark import conformer, graphs, harness
    from benchmark.reference import conformer as ref_am, fbank as ref_fbank, \
        graph as ref_graph
    from benchmark.traffic.offline_bucketed import judge, pool_rows, \
        wave_rows
    cfg, p, dev, seed = ctx.cell.config, ctx.params, ctx.device, ctx.seed
    g = graphs.make_graph({**cfg["graph"], "seed": seed}, harness.CACHE,
                          harness.log)
    idx = ref_graph.ArcIndex(g)
    weights = [(k, w) for k, _, _, _, w in
               conformer.weights(cfg["am"], seed, dev)]
    batches = pool_rows(p, seed)
    rng = np.random.default_rng([seed, 6])     # the cell's draw of rows
    kept, paths, rows = {}, {}, []
    for i, n in enumerate(batches):
        drawn = np.sort(np.r_[0, len(n) - 1, 1 + rng.choice(
            len(n) - 2, p["sample_rows"] - 2, replace=False)])
        rows.append(np.unique(np.r_[drawn[0], drawn[-1],
                                    drawn[1:rows_cap - 1]]))
        waves = wave_rows(seed, i, n, dev)
        lows, results, paths[i] = [], [], []
        for b in rows[i]:
            with torch.no_grad():
                feats = ref_fbank.fbank(waves[b:b + 1, :int(n[b])],
                                        cfg["fbank"]["num_bins"])[0]
                low = ref_am.forward(weights, feats, precision="tf32")
            arcs, cost, reached = ref_graph.viterbi(idx, low, "fp32")
            lows.append(low.cpu().numpy())
            paths[i].append(arcs)
            results.append({"words": [a[3] for a in arcs if a[3] != 0],
                            "cost": cost, "reached_final": reached})
        T = max(len(x) for x in lows)
        ll = np.zeros((len(lows), T, lows[0].shape[1]), np.float32)
        for j, x in enumerate(lows):
            ll[j, :len(x)] = x
        kept[i] = (ll, np.array([len(x) for x in lows]), results)
    return {k: (v, ctx.limits[k]) for k, v in
            judge(ctx, g, kept, paths, rows, batches).items()}


def narrowed(width: int):
    """The program's ``TorchBeamSearch`` built at width ``width``."""
    from asr_decoder_tpu_torch.ops import beamsearch
    made = beamsearch.TorchBeamSearch

    def build(fst, ilabel2pdf, config, **kw):
        return made(fst, ilabel2pdf, dataclasses.replace(
            config, beam_width=width, max_active=width,
            min_active=min(config.min_active, width)), **kw)
    return mock.patch.object(beamsearch, "TorchBeamSearch", build)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import time
    import torch
    from benchmark import harness, run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = "conformer_l.offline"
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.width:
            with narrowed(args.width):
                r = run.run_cell(name, seed, args.seconds, False)
            line = {"seed": seed, "control": f"width {args.width}",
                    "correct": r["correct"], "checks": r["checks"]}
        else:
            ctx = harness.Context(harness.cell(name), seed, args.seconds,
                                  False, torch.device("cuda"),
                                  time.monotonic())
            checks = control_checks(ctx, args.rows)
            line = {"seed": seed, "control": "tf32",
                    "correct": harness.correct(checks),
                    "checks": harness.check_lines(checks)}
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
