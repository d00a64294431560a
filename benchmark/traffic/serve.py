"""Serving cells: ``AsrServer`` over TCP on localhost, driven by the load
generator's process (``traffic/loadgen.py``).

Set-up (all of it ``setup_s``): the graph and the AM's weights from the
seed, the program's ``OnlineDecoderInfo`` built in memory as
``cli/_model.py:build_info`` builds it (TF32 off), an ``AsrServer`` of
``channels`` channels, one utterance pushed through its arena to capture
the AM chunk's and the search frame's graphs at the arena's width, and the
generator's warm-up (``warm_s``), after which the window opens.

End-to-end arithmetic over the window [t0, t0 + seconds):
``serve_audio_s_per_s``: the audio of every push answered inside the
window over the window.

What is judged: for a sample of the utterances (drawn from the seed, with
the longest), the server keeps what its own timed path produced at the
final reply: the log-likelihoods its arena computed, the best path its
traceback found; the client keeps the words and cost it was answered.
The reference recomputes fbank and the AM from the utterance's audio and
the seed's weights, judges the path (``reference/graph.py``) and holds
its cost against the least cost of any path of the graph over those
log-likelihoods."""

from __future__ import annotations

import asyncio
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import graphs, harness, inputs
from benchmark.harness import Outcome, log
from benchmark.traffic.loadgen import UID_SHIFT, lengths


class Setup:
    """The program under test for one serving run."""

    def __init__(self, ctx):
        import torch
        from asr_decoder_tpu_torch.decoder.config import DecoderConfig
        from asr_decoder_tpu_torch.frontend.fbank import FbankConfig
        from asr_decoder_tpu_torch.fst.symbol import SymbolTable
        from asr_decoder_tpu_torch.models.nnet import AmConfig
        from asr_decoder_tpu_torch.serving.server import AsrServer, SocketConfig
        from asr_decoder_tpu_torch.serving.session import (
            OnlineDecoderConfig, OnlineDecoderInfo)
        cfg, p = ctx.cell.config, ctx.params
        self.ctx = ctx
        dev = ctx.device
        self.graph = graphs.make_graph({**cfg["graph"], "seed": ctx.seed},
                                       harness.CACHE, log)
        self.fst = inputs.port_fst(self.graph)
        nnet = inputs.port_nnet(inputs.am_weights(cfg["am"], ctx.seed, dev),
                                dev)
        words = SymbolTable()
        words.add("<eps>", 0)
        for w in range(1, int(self.graph.olabel.max()) + 1):
            words.add(f"w{w}", w)
        info = OnlineDecoderInfo(
            nnet, self.fst, words, self.graph.ilabel2pdf,
            decoder_config=DecoderConfig(**cfg["search"]),
            online_config=OnlineDecoderConfig(**cfg["online"]),
            fbank_config=FbankConfig(**cfg["fbank"]),
            am_config=AmConfig(skip=cfg["am"]["skip"]), device=dev)
        self.info = info
        self.kept: dict = {}
        self.keep_finals = False
        self.ticks: list = []
        self._tls = threading.local()
        if ctx.trace and dev.type == "cuda":
            from asr_decoder_tpu_torch.ops import gather
            gather.shapes = set()   # each capture records its launches
        self.server = AsrServer(info, SocketConfig(
            ip="127.0.0.1", port=0, num_channels=p["channels"],
            rec_timeout=60))
        self._instrument()
        self._warm(torch)

    def _instrument(self) -> None:
        """Keep, at a kept utterance's final reply, the snapshot's
        log-likelihoods and the best path the reply was built from; in a
        traced run also time each reply's build and each arena tick."""
        server, batcher = self.server, self.server._batcher
        best_from, results = batcher.get_best_path_from, server._results
        tls, spans, trace = self._tls, self.ctx.spans, self.ctx.trace

        def best_kept(snap):
            tls.best = best_from(snap)
            return tls.best

        def results_kept(snap, pkg, final, *rest):
            t0 = time.perf_counter()
            out = results(snap, pkg, final, *rest)
            if trace:
                spans.add("result", t0, time.perf_counter())
            if pkg.end_flag and self.keep_finals:
                # references only: the snapshot's list is already a copy
                self.kept[pkg.n >> UID_SHIFT] = dict(
                    loglikes=snap.loglikes, frames=snap.frames_decoded,
                    best=tls.best)
            return out
        batcher.get_best_path_from = best_kept
        server._results = results_kept
        if trace:
            step = batcher.step
            C = self.server.info.config.chunk_frames

            def tick():
                # the frames each ready channel will give this tick (read
                # from the arena's host state before it steps)
                frames = sum(min(C, batcher._channels[c].pending_frames)
                             for c in range(batcher.B) if batcher.ready(c))
                t0 = time.perf_counter()
                advanced = step()
                if advanced:
                    t1 = time.perf_counter()
                    spans.add("tick", t0, t1)
                    self.ticks.append((t0, t1, frames, len(advanced)))
                return advanced
            batcher.step = tick

    def _warm(self, torch) -> None:
        """One utterance through the arena and a reply built from it: the
        first call of each static key captures its graph."""
        from asr_decoder_tpu_torch.serving.protocol import C2SPackage
        b = self.server._batcher
        audio = inputs.wave(self.ctx.seed, (1 << 19) - 1, 2.0)
        cid = b.acquire()
        step = int(self.ctx.params["push_s"] * 16000)
        for k in range(0, len(audio), step):
            last = k + step >= len(audio)
            b.push(cid, audio[k:k + step].astype(np.float32), last)
            while b.ready(cid):
                b.step()
            snap = b.snapshot(cid)
            self.server._results(snap, C2SPackage(end_flag=last), last,
                                 [], [], 0)
        b.release(cid)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        self.ticks.clear()
        self.ctx.spans.by_name.clear()

    def drive(self, params: dict, seconds: float, profile: bool) -> dict:
        """Run the generator once, keeping what each final reply was built
        from: returns its record, with the window [t0, t1) (monotonic),
        the server's counters at both ends and, if ``profile``, the device
        trace of a sub-window in its middle."""
        self.keep_finals = True
        try:
            return asyncio.run(self._drive(params, seconds, profile))
        finally:
            self.server = None

    async def _drive(self, params, seconds, profile) -> dict:
        server = self.server
        host, port = await server.start()
        job = {"host": host, "port": port, "seed": self.ctx.seed,
               "seconds": seconds, "params": params}
        proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.traffic.loadgen"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=harness.ROOT)
        loop = asyncio.get_running_loop()
        try:
            proc.stdin.write((json.dumps(job) + "\n").encode())
            proc.stdin.close()
            t_base = json.loads(await loop.run_in_executor(
                None, proc.stdout.readline))["t_base"]
            t0 = t_base + params["warm_s"]
            t1 = t0 + seconds
            out = {"t0": t0, "t1": t1}
            await asyncio.sleep(max(0.0, t0 - time.monotonic()))
            out["counters0"] = (server.dispatches, server.chunks_decoded)
            if profile:
                # the profiler starts and stops on the server's device
                # thread, between two of its CUDA calls: started or stopped
                # from another thread while that one replayed graphs, it
                # hung 2 runs of 10 on the card
                prof = harness.Profiler()
                lead = max(0.0, (seconds - params["profile_s"]) / 2)
                await asyncio.sleep(max(0.0, t0 + lead - time.monotonic()))
                await loop.run_in_executor(server._pool, prof.start)
                await asyncio.sleep(params["profile_s"])
                out["trace"] = await loop.run_in_executor(server._pool,
                                                          prof.stop)
            await asyncio.sleep(max(0.0, t1 - time.monotonic()))
            out["counters1"] = (server.dispatches, server.chunks_decoded)
            line = await loop.run_in_executor(None, proc.stdout.readline)
            out.update(json.loads(line))
        finally:
            await loop.run_in_executor(None, proc.wait)
            await stop(server)
        return out

    def close(self) -> None:
        """Drop the program's state (the caller reads the peak memory
        first)."""
        import torch
        for one in self.kept.values():
            one["path"] = inputs.port_path(self.fst, one["best"]["arc_ids"])
            one["loglikes"] = (np.concatenate(one["loglikes"], axis=0)
                               if one["loglikes"] else
                               np.zeros((0, 0), np.float32))
        self.server = self.info = self.fst = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()


async def stop(server, timeout_s: float = 30.0) -> None:
    """Stop the server.  Under a backlog ``AsrServer.stop`` can wait
    forever: it cancels the device loop, then waits for connections whose
    handlers wait on that loop (Open questions in PERF.md); past
    ``timeout_s`` the run goes on and the interpreter's exit ends the
    threads."""
    try:
        await asyncio.wait_for(server.stop(), timeout_s)
    except asyncio.TimeoutError:
        log(f"AsrServer.stop did not return in {timeout_s:.0f} s")
        server._pool.shutdown(wait=False, cancel_futures=True)
        server._result_pool.shutdown(wait=False, cancel_futures=True)


def judge_sample(params: dict, seed: int, rec: dict, lens) -> list:
    """The finished utterances the judge reads: a sample drawn from the
    seed among those whose last push was sent in the window and
    answered, and the longest of them."""
    t0, t1 = rec["t0"], rec["t1"]
    cand = sorted(int(r[0]) for r in rec["pushes"]
                  if r[4] and r[3] is not None and t0 <= r[2] < t1)
    if not cand:
        return []
    rng = np.random.default_rng([seed, 5])
    n = min(params["sample_utts"], len(cand))
    pick = set(rng.choice(cand, n, replace=False).tolist())
    pick.add(max(cand, key=lambda u: lens[u % len(lens)]))
    return sorted(pick)


def judge(ctx, setup_graph, kept: dict, rec: dict) -> dict:
    """The compared numbers: ``am_err`` (largest |log-likelihood - the
    reference's| over the kept utterances' frames), ``cost_err`` (largest
    relative gap of an answered cost), ``path_faults`` (utterances whose
    path or answer is wrong, or that were not answered), ``search_gap``
    (largest relative gap of an answered cost above the exact best)."""
    import torch
    from benchmark.reference import am as ref_am, fbank as ref_fbank, \
        graph as ref_graph
    cfg = ctx.cell.config
    dev = ctx.device
    idx = ref_graph.ArcIndex(setup_graph)
    weights = [(k, p) for k, _, _, _, p in
               inputs.am_weights(cfg["am"], ctx.seed, dev)]
    lens = lengths({"params": ctx.params, "seed": ctx.seed})
    am_err, cost_err, faults = 0.0, 0.0, 0
    answered = []
    finals = {int(k): v for k, v in rec["finals"].items()}
    sample = judge_sample(ctx.params, ctx.seed, rec, lens)
    judged = 0
    for uid in sample:
        kept_one = kept.get(uid)
        if kept_one is None or uid not in finals:
            faults += 1
            continue
        wave = inputs.wave(ctx.seed, uid, float(lens[uid % len(lens)]))
        with torch.no_grad():
            feats = ref_fbank.fbank(torch.from_numpy(
                wave.astype(np.float32))[None].to(dev),
                cfg["fbank"]["num_bins"])
            ll = ref_am.forward(weights, feats, skip=cfg["am"]["skip"],
                                splice_first=True)[0].double().cpu().numpy()
        port_ll = kept_one["loglikes"]
        frames = kept_one["frames"]
        if port_ll.shape != ll.shape or frames != len(ll):
            faults += 1
            continue
        am_err = max(am_err, float(np.abs(port_ll - ll).max()))
        best = kept_one["best"]
        words, cost = finals[uid]
        reached = best.get("reached_final", False)
        bad, gap, total = ref_graph.judge_path(
            idx, kept_one["path"], frames, ll, words, cost, reached)
        if bad:
            log(f"utterance {uid}: {'; '.join(bad)}")
            faults += 1
        else:
            answered.append((ll, total, reached))
        cost_err = max(cost_err, gap)
        judged += 1
    if judged == 0:
        faults += 1
    gap = ref_graph.search_gap(idx, answered, dev)
    log(f"judged {judged} of {len(sample)} sampled utterances "
        f"({len(kept)} finals kept); search gap {gap!r}")
    return {"am_err": am_err, "cost_err": cost_err, "path_faults": faults,
            "search_gap": gap}


def run(ctx) -> Outcome:
    import torch
    p = ctx.params
    setup = Setup(ctx)
    graph = setup.graph
    rec = setup.drive(p, ctx.seconds, ctx.trace)
    setup_s = rec["t0"] - ctx.process_start
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    kept, ticks = setup.kept, setup.ticks
    setup.close()
    t0, t1 = rec["t0"], rec["t1"]
    answered = sum(r[5] for r in rec["pushes"]
                   if r[3] is not None and t0 <= r[3] < t1)
    e2e = {"serve_audio_s_per_s": answered / ctx.seconds,
           "setup_s": setup_s}
    finals = sum(1 for r in rec["pushes"]
                 if r[4] and r[3] is not None and t0 <= r[3] < t1)
    log(f"window: {answered:.1f} audio-s answered, {finals} finals; "
        f"{len(rec['failed'])} streams failed")
    # every push sent in the window, and those never answered
    sent = [r for r in rec["pushes"] if t0 <= r[2] < t1]
    attempted, failed = len(sent), sum(r[3] is None for r in sent)
    checks = judge(ctx, graph, kept, rec)
    checks = {k: (v, ctx.limits[k]) for k, v in checks.items()}
    shift = time.perf_counter() - time.monotonic()
    data = {"window": (t0 + shift, t1 + shift), "counters": (rec["counters0"],
                                             rec["counters1"]),
            "spans": ctx.spans, "ticks": ticks, "config": ctx.cell.config,
            "channels": p["channels"], "device": ctx.device}
    if "trace" in rec:
        data["trace"] = rec["trace"]
        data["peaks"] = harness.PEAKS.get(
            torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "", None)
    if ctx.trace and ctx.device.type == "cuda":
        from asr_decoder_tpu_torch.ops import gather
        data["gather_shapes"] = gather.shapes
    return Outcome(e2e, attempted, failed, checks, peak, data)
