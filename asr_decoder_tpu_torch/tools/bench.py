"""End-to-end decode throughput tool: the three operating points of the JAX
package's root ``bench.py``, on one GPU.

Pipeline — the reference's canonical serve path (SURVEY §3.1: fbank → AM
forward → WFST beam search), batched: 16 kHz waveform batch → 80-dim fbank →
flagship projected-LSTM AM with frame-subsampling 3 → batched
frame-synchronous Viterbi beam search with full backpointer logging →
per-utterance words.  On a card the AM pass (``GraphedAm``) and every
search frame are replays of captured CUDA graphs, as the JAX script's are
compiled programs.

Three operating points, the same shapes and numpy seeds as the JAX script:
  * headline — 200k-state HCLG-shaped graph, 256 concurrent streams of 8 s,
    beam 14, K = 512, ``arc_lanes=8``.
  * production — a COMPOSED ≥2M-state TLG (lexicon tries over a synthetic
    4-gram ARPA LM, ``lm/synth_arpa`` + ``fst/tlg``), beam 12, K = 4096,
    ``topk_overfetch=1``, 32 streams × 264 frames of CTC-spiky posteriors,
    blank frames packed out with ``pack_nonblank_frames``; graph build,
    save, load and upload are timed.  The built graph is cached under the
    checkout's ``build/`` (``build_or_load_tlg``).
  * realistic — 30k-word single-hub trie CTC graph, K = 1024, 64 × 160.

What this tool reports that the JAX script does not: every timed call is
repeated ``--pairs`` times after a warm-up, each ended by a device
synchronize, and the median, min and max are printed (frame times swing
between calls, so no single best-of-3); the blank threshold in use and the
packed frame count at it and at log 0.95; words with and without packing;
the effective K = min(beam_width, max_active) and how often the emit
stage's candidate count reaches the K·F cut of ``topk_overfetch``; the two
relax engines (v2 = sort, v3 = topk) in alternating pairs at headline and
realistic; and, with ``--profile-dir``, kernels per frame and the top
device kernels of a few profiled frames per point.

Like the JAX script it compares the headline figure with the reference's
production CPU serving node, which decodes ``BASELINE_AUDIO_S_PER_S`` = 60
audio-seconds per second: ``vs_baseline`` = the headline pipeline median
/ 60, rounded to 3 places.

Prints human-readable progress on stderr and exactly one JSON line on
stdout: ``{"metric": "audio_seconds_per_second_per_gpu", "value": headline
pipeline median, "unit", "vs_baseline", "device", "pairs", "timing",
"detail": {"headline": {...}, "production": {...}, "realistic": {...},
"v2_vs_v3": {...}}}``.  Each point has ``graph_states``, ``batch``,
``frames``, ``relax``, ``effective_K``, ``kf_bind`` and ``search_ms`` (a
dict of median/min/max).

Usage: python -m asr_decoder_tpu_torch.tools.bench [--quick]
       [--device cuda|cpu] [--pairs N] [--profile-dir=DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from asr_decoder_tpu_torch.ops._build import BUILD_DIR
from asr_decoder_tpu_torch.ops.beamsearch import CLO_BIT
from asr_decoder_tpu_torch.tools.perf._common import (device_arg,
                                                      device_line,
                                                      open_device)

NUM_PDFS = 2048
# the reference's production CPU serving node decodes ~60 concurrent
# real-time streams (--nthread=60 at decoder RTF ~1, ref:
# src/v2-asrbin/conf/v2-conf.txt): ~60 audio-seconds per second
BASELINE_AUDIO_S_PER_S = 60.0
# the JAX script's packing threshold (its comment says 0.95, its code 0.75):
# kept for the same packed frame count; ``models/nnet.py`` recommends 0.95
BLANK_THRESH = float(np.log(0.75))
BLANK_THRESH_DOC = float(np.log(0.95))
PROFILE_FRAMES = 4      # the profiler stretches the host; a few frames do

# the production LM, full size and the size ``--quick`` runs
TLG_FULL = dict(vocab_size=40_000, n_bigram=220_000, n_trigram=130_000,
                n_4gram=60_000)
TLG_QUICK = dict(vocab_size=300, n_bigram=1_500, n_trigram=800, n_4gram=300)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device, repeats: int) -> dict:
    """``fn()`` once as warm-up, then ``repeats`` times, each between two
    device synchronizes: wall ms (median, min, max) and, on a card, the
    median of the CUDA-event time of the same calls."""
    fn()
    walls, events = [], []
    on_card = device.type == "cuda"
    for _ in range(repeats):
        _sync(device)
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        fn()
        if on_card:
            e1.record()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            events.append(e0.elapsed_time(e1))
    out = {"median": round(statistics.median(walls), 3),
           "min": round(min(walls), 3), "max": round(max(walls), 3),
           "repeats": repeats}
    if events:
        out["event_median"] = round(statistics.median(events), 3)
    return out


def kf_bind(search, init_log, logs, frame_mask=None) -> dict | None:
    """How often the K·F candidate cut of the v3 emit stage binds: per
    (row, frame), the emitting arcs leaving the tokens that enter the frame
    (from the token snapshots and the graph's degrees) against
    ``min(K·F, K·A)``.  None for the v2 engine, which has no such cut."""
    if search.relax_impl != "topk":
        return None
    K, A = search.beam_width, search.A
    cut = min(K * int(search.config.topk_overfetch), K * A)
    deg = torch.from_numpy(search.dev.em_count.astype(np.int64)).to(
        search.device)
    entering = torch.cat([init_log.tok_state[None], logs.tok_state[:-1]])
    T, B, _ = entering.shape
    cand = torch.empty((T, B), dtype=torch.int64, device=search.device)
    for t in range(T):                      # a frame at a time: small temps
        st = entering[t]
        live = st >= 0
        cand[t] = torch.where(live, deg[(st & ~CLO_BIT).clamp(min=0)
                                        .long()], 0).sum(dim=1)
    rows = torch.ones((T, B), dtype=torch.bool, device=search.device) \
        if frame_mask is None else \
        torch.as_tensor(frame_mask, device=search.device).bool().t()
    hit = (cand >= cut) & rows
    return {"cut_K_times_F": cut,
            "row_frames_at_cut": int(hit.sum()),
            "row_frames": int(rows.sum()),
            "frames_at_cut": int(hit.any(dim=1).sum()),
            "frames": T,
            "max_candidates": int(torch.where(rows, cand, 0).max())}


def profile_frames(search, state, ll, mask, point: str, profile_dir: str,
                   frame_ms: float) -> dict:
    """Trace ``PROFILE_FRAMES`` search frames with ``torch.profiler``; the
    Chrome trace goes to ``<profile_dir>/<point>/trace.json`` and the
    report (to stderr) and its summary come from
    ``tools/perf/profile_production.report``."""
    from asr_decoder_tpu_torch.tools.perf.profile_production import report
    from asr_decoder_tpu_torch.utils.profiling import trace
    F = min(PROFILE_FRAMES, ll.shape[1])
    sub_mask = None if mask is None else mask[:, :F]
    with trace(f"{profile_dir}/{point}") as prof:
        search.advance(state, ll[:, :F], sub_mask)
        _sync(search.device)
    with contextlib.redirect_stdout(sys.stderr):
        return report(prof, F, search.device.type == "cuda", frame_ms)


@dataclass
class PointRun:
    """One point's JSON ``report`` and what a caller may want to check it
    with (``keep``: the search, its inputs and results, by name)."""
    report: dict
    keep: dict = field(default_factory=dict)


def _search_report(search, dev, B: int, T: int) -> dict:
    return {"graph_states": int(dev.num_states), "batch": B, "frames": T,
            "relax": search.relax_impl, "eps_mode": search.mode,
            "beam": search.config.beam,
            "beam_width": search.config.beam_width,
            "max_active": search.config.max_active,
            "effective_K": search.beam_width,
            "topk_overfetch": search.config.topk_overfetch}


def _time_search(search, ll, mask, device, pairs, audio_s, profile_dir,
                 point) -> tuple[dict, tuple]:
    """The timed part every point shares: ``advance`` from a fresh beam
    over ``audio_s`` seconds of audio, then one logged decode for the live
    count, the K·F counter and the words' traceback."""
    B, T = ll.shape[:2]
    state0, init_log = search.init_state(B)
    rep = {"search_ms": timed(
        lambda: search.advance(state0, ll, mask), device, pairs)}
    ms = rep["search_ms"]["median"]
    rep["search_ms_per_frame"] = round(ms / T, 4)
    rep["search_audio_s_per_s"] = round(audio_s / (ms / 1e3), 1)
    state, logs = search.advance(state0, ll, mask)
    live = torch.isfinite(state.tok_cost).sum(dim=1)
    rep["live_mean"] = int(live.float().mean())
    rep["live_max"] = int(live.max())
    rep["kf_bind"] = kf_bind(search, init_log, logs, mask)
    if profile_dir:
        rep["profile"] = profile_frames(search, state0, ll, mask, point,
                                        profile_dir, ms / T)
    return rep, (state, init_log, logs)


def v2_vs_v3(dev, i2p, cfg_kw: dict, ll, mask, device, pairs: int) -> dict:
    """The two relax engines on one graph and one input, ``pairs``
    alternating pairs (v2 first, then v3 first, ...), each call between
    device synchronizes.  Prints what it measured; it picks no default."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    runs = {}
    for name, impl in (("v2", "sort"), ("v3", "topk")):
        s = TorchBeamSearch(dev, i2p, DecoderConfig(**cfg_kw,
                                                    relax_impl=impl),
                            device=device)
        st, _ = s.init_state(ll.shape[0])
        runs[name] = (lambda s=s, st=st: s.advance(st, ll, mask))
        runs[name]()                                        # warm-up
    out = {"v2": [], "v3": []}
    for p in range(pairs):
        for name in (("v2", "v3") if p % 2 == 0 else ("v3", "v2")):
            _sync(device)
            t0 = time.perf_counter()
            runs[name]()
            _sync(device)
            out[name].append(round((time.perf_counter() - t0) * 1e3, 3))
    wins = sum(a < b for a, b in zip(out["v2"], out["v3"]))
    return {"pairs_ms": list(zip(out["v2"], out["v3"])),
            "v2_median": round(statistics.median(out["v2"]), 3),
            "v3_median": round(statistics.median(out["v3"]), 3),
            "v2_faster_in": wins, "of": pairs}


# ----------------------------------------------------------------------
# headline
# ----------------------------------------------------------------------

def headline(device, *, pairs: int = 10, batch: int = 256,
             states: int = 200_000, secs: float = 8.0,
             profile_dir: str | None = None, engines: bool = True
             ) -> PointRun:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.frontend.fbank import (FbankConfig,
                                                      compute_fbank)
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    from asr_decoder_tpu_torch.models.nnet import GraphedAm
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch

    rng = np.random.default_rng(0)
    sr, skip = 16000, 2       # frame-subsampling-factor 3 (ref conf)
    fb_cfg = FbankConfig(num_bins=80)
    nnet = make_flagship(0, feat_dim=80, num_pdfs=NUM_PDFS, hidden=1024,
                         proj=512, num_layers=3, device=device)
    am_state = nnet.init_state(batch, device)
    fst = random_hclg(rng, num_states=states, num_ilabels=NUM_PDFS)
    dev = DeviceFst.build(fst, arc_lanes=8)
    # the search scores ilabel i against AM row (i-1): CTC-style map
    # (ref: nnet-nnet.h:226 "ilabel - 1")
    i2p = np.concatenate([[0], np.arange(NUM_PDFS)]).astype(np.int32)
    cfg_kw = dict(beam=14.0, beam_width=512, arc_lanes=8, max_active=512,
                  min_active=16, eps_mode="closure")
    search = TorchBeamSearch(dev, i2p, DecoderConfig(**cfg_kw),
                             device=device)
    wave = torch.from_numpy(
        (rng.standard_normal((batch, int(sr * secs))) * 1000)
        .astype(np.float32)).to(device)

    am = GraphedAm(nnet.layers)

    @torch.inference_mode()
    def am_fn(w):
        feats = compute_fbank(fb_cfg, w)
        ll, _ = am(feats, am_state, skip=skip)
        return ll

    def pipeline():
        state, _ = search.init_state(batch)
        return search.advance(state, am_fn(wave))

    ll = am_fn(wave)
    T = ll.shape[1]
    audio_s = batch * secs
    rep = _search_report(search, dev, batch, T)
    rep["wave_secs"] = secs
    rep["am_ms"] = timed(lambda: am_fn(wave), device, pairs)
    srep, (state, init_log, logs) = _time_search(
        search, ll, None, device, pairs, audio_s, profile_dir, "headline")
    rep.update(srep)
    rep["pipeline_ms"] = timed(pipeline, device, pairs)
    rep["am_audio_s_per_s"] = round(
        audio_s / (rep["am_ms"]["median"] / 1e3), 1)
    rep["audio_s_per_s"] = {
        "median": round(audio_s / (rep["pipeline_ms"]["median"] / 1e3), 2),
        "min": round(audio_s / (rep["pipeline_ms"]["max"] / 1e3), 2),
        "max": round(audio_s / (rep["pipeline_ms"]["min"] / 1e3), 2)}
    t0 = time.perf_counter()
    results = search.traceback(state, init_log, logs, fst)
    rep["traceback_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    rep["words_mean"] = round(float(np.mean([len(r["words"])
                                             for r in results])), 1)
    log(f"headline: B={batch} T={T} S={dev.num_states} K={search.beam_width}"
        f" am {rep['am_ms']['median']} ms, search "
        f"{rep['search_ms']['median']} ms ({rep['search_ms_per_frame']} "
        f"ms/frame), pipeline {rep['pipeline_ms']['median']} ms "
        f"[{rep['pipeline_ms']['min']}, {rep['pipeline_ms']['max']}], "
        f"{rep['audio_s_per_s']['median']} audio-s/s; kf_bind "
        f"{rep['kf_bind']}")
    engines_rep = v2_vs_v3(dev, i2p, cfg_kw, ll, None, device, pairs) \
        if engines else None
    return PointRun(rep, dict(
        nnet=nnet, fb_cfg=fb_cfg, skip=skip, wave=wave, ll=ll, fst=fst,
        dev=dev, i2p=i2p, cfg_kw=cfg_kw, search=search, results=results,
        engines=engines_rep))


# ----------------------------------------------------------------------
# production: the composed TLG
# ----------------------------------------------------------------------

def _tlg_posteriors(rng, lexicon, num_phones, B, T):
    """Realistic peaked posteriors over a TLG's phone set: word sequences
    rendered as per-phone template frames + noise, log-softmax scored
    (the eval harness's template model, eval/synth_task.py)."""
    t = rng.standard_normal((num_phones + 1, 24))
    # scale 2.5 ⇒ top posterior ~0.95+: the sharpness trained CTC AMs
    # actually produce (blank spikes confidently skippable)
    templates = (t / np.linalg.norm(t, axis=1, keepdims=True)
                 ).astype(np.float32) * 2.5
    words = sorted(lexicon)
    lls = np.zeros((B, T, num_phones + 1), np.float32)
    for b in range(B):
        # CTC-spiky emissions (what trained CTC AMs actually produce at a
        # subsampled frame rate): ~1 frame per phone spike, blank frames
        # between — the regime the reference's skip-block targets
        rows = [0, 0]
        while len(rows) < T:
            w = words[int(rng.integers(0, len(words)))]
            for q in lexicon[w]:
                rows.extend([q] * int(rng.integers(1, 3)))
                rows.extend([0] * int(rng.integers(0, 3)))
            rows.append(0)
        rows = rows[:T]
        feats = templates[np.array(rows)] + \
            rng.standard_normal((T, 24)).astype(np.float32) * 0.35
        sc = feats @ templates.T
        lls[b] = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
    return lls


@dataclass
class Tlg:
    """The production graph and what was drawn while building it."""
    fst: object                 # StdFst (source arcs, for the words)
    dev: object                 # DeviceFst, ε-closure built
    i2p: np.ndarray
    lexicon: dict
    num_phones: int
    rng: np.random.Generator    # the lexicon's generator, after the lexicon
    lm_states: int
    build_s: float              # ARPA text + parse + lexicon + build_tlg
    device_build_s: float       # DeviceFst.build + build_closure
    cached: bool


def build_or_load_tlg(lm: dict | None = None, num_phones: int = 40) -> Tlg:
    """The production point's composed TLG: ``synth_arpa_text(**lm,
    seed=1)`` → ``parse_arpa`` → a lexicon of 3-7 phones a word from
    ``default_rng(1)`` → ``build_tlg`` → ``DeviceFst.build(arc_lanes=16)``
    with its ε-closure.  Saved under the checkout's ``build/`` (the StdFst
    binary, ``DeviceFst.save`` and a small ``.meta.npz`` with the lexicon,
    the generator's state and the build times) and loaded from there when
    the files exist."""
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.fst import StdFst
    from asr_decoder_tpu_torch.fst.tlg import build_tlg
    from asr_decoder_tpu_torch.lm.arpa import parse_arpa
    from asr_decoder_tpu_torch.lm.synth_arpa import synth_arpa_text
    lm = dict(TLG_FULL if lm is None else lm)
    stem = BUILD_DIR / ("tlg_" + "_".join(str(lm[k]) for k in sorted(lm)))
    meta_path = stem.with_suffix(".meta.npz")
    rng = np.random.default_rng(1)
    if meta_path.exists():
        z = np.load(meta_path, allow_pickle=False)
        # an NpzFile reads its array from disk at every ``z[...]``
        off, phones = z["lex_off"], z["lex_phones"].tolist()
        lexicon = {int(w): phones[a:b]
                   for w, a, b in zip(z["lex_words"], off[:-1], off[1:])}
        rng.bit_generator.state = json.loads(str(z["rng_state"]))
        fst = StdFst.read_binary(str(stem.with_suffix(".fst")))
        fst.olabel_anchor = "end"
        dev = DeviceFst.load(str(stem.with_suffix(".npz")))
        log(f"loaded cached TLG {stem}: S={dev.num_states}")
        return Tlg(fst, dev, z["i2p"], lexicon, num_phones, rng,
                   int(z["lm_states"]), float(z["build_s"]),
                   float(z["device_build_s"]), True)
    t0 = time.perf_counter()
    fsa = parse_arpa(synth_arpa_text(**lm, seed=1))
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if not wname.startswith("w"):
            continue
        n = int(rng.integers(3, 8))
        ph = [int(rng.integers(1, num_phones + 1))]
        while len(ph) < n:
            p = int(rng.integers(1, num_phones + 1))
            if p != ph[-1]:
                ph.append(p)
        lexicon[wid] = ph
    fst, i2p = build_tlg(lexicon, fsa, num_phones)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = DeviceFst.build(fst, arc_lanes=16)
    dev.build_closure()
    device_build_s = time.perf_counter() - t0
    i2p = np.asarray(i2p, np.int32)
    log(f"built TLG: S={dev.num_states} arcs={fst.num_arcs} in "
        f"{build_s:.1f} + {device_build_s:.1f} s")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fst.write_binary(str(stem.with_suffix(".fst")))
    dev.save(str(stem.with_suffix(".npz")))
    tmp = stem.with_suffix(".meta.tmp.npz")
    np.savez(tmp, i2p=i2p, lex_words=np.array(list(lexicon), np.int64),
             lex_off=np.concatenate(
                 [[0], np.cumsum([len(p) for p in lexicon.values()])]),
             lex_phones=np.concatenate(
                 [np.asarray(p, np.int32) for p in lexicon.values()]),
             rng_state=json.dumps(rng.bit_generator.state),
             lm_states=fsa.num_states, build_s=build_s,
             device_build_s=device_build_s)
    tmp.replace(meta_path)           # the meta file marks a whole cache
    return Tlg(fst, dev, i2p, lexicon, num_phones, rng, fsa.num_states,
               build_s, device_build_s, False)


def production(device, *, pairs: int = 10, lm: dict | None = None,
               batch: int = 32, frames: int = 264, beam_width: int = 4096,
               profile_dir: str | None = None) -> PointRun:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch

    t0 = time.perf_counter()
    tlg = build_or_load_tlg(lm)
    get_s = time.perf_counter() - t0
    # the deployment's start-up: the prebuilt graph from disk to a search
    path = BUILD_DIR / "tlg_roundtrip.npz"
    t0 = time.perf_counter()
    tlg.dev.save(str(path))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = DeviceFst.load(str(path))
    load_s = time.perf_counter() - t0
    path.unlink()
    # topk_overfetch=1 is the JAX point's setting, kept for parity.  The
    # K·F candidate cut does bind here: the trie's hubs fan out 16 wide, so
    # a row of ~740 live tokens can offer over 4,096 candidates, and
    # ``kf_bind`` counted the cut reached in about 39% of row-frames.  What
    # that costs in words is not measured (F = 1 against F = 2)
    cfg_kw = dict(beam=12.0, beam_width=beam_width, arc_lanes=16,
                  max_active=beam_width, min_active=min(200, beam_width),
                  eps_mode="closure", topk_overfetch=1)
    t0 = time.perf_counter()
    search = TorchBeamSearch(dev, tlg.i2p, DecoderConfig(**cfg_kw),
                             device=device)
    _sync(device)
    upload_s = time.perf_counter() - t0
    raw_host = _tlg_posteriors(tlg.rng, tlg.lexicon, tlg.num_phones, batch,
                               frames)
    raw = torch.from_numpy(raw_host).to(device)
    # CTC blank-skip frame packing (ref SkipBlockFrame,
    # nnet-nnet.h:265-275): confidently-blank frames never reach the search
    packed, pmask = pack_nonblank_frames(raw, 0, thresh=BLANK_THRESH)
    Tp = packed.shape[1]
    rep = _search_report(search, dev, batch, frames)
    rep.update({
        "graph": "composed TLG (trie ∘ 4-gram ARPA)",
        "graph_arcs": int(tlg.fst.num_arcs), "lm_states": tlg.lm_states,
        "vocab": len(tlg.lexicon), "subsampling": 3,
        "blank_threshold": {"prob": 0.75, "log": round(BLANK_THRESH, 5)},
        "packed_frames": Tp,
        "packed_frames_at_log_0.95": int(pack_nonblank_frames(
            raw, 0, thresh=BLANK_THRESH_DOC)[0].shape[1]),
        "pack_ms": timed(lambda: pack_nonblank_frames(
            raw, 0, thresh=BLANK_THRESH), device, pairs),
        "graph_build_s": round(tlg.build_s, 1),
        "graph_device_build_s": round(tlg.device_build_s, 1),
        "graph_cached": tlg.cached,
        "graph_get_s": round(get_s, 1),   # the build, or the cache's load
        "graph_save_s": round(save_s, 1), "graph_load_s": round(load_s, 1),
        "graph_upload_s": round(upload_s, 1)})
    # Tp frames are subsampled ×3 (frame-subsampling-factor 3, the
    # reference production conf): a frame of the unpacked input is 30 ms
    srep, (state, init_log, logs) = _time_search(
        search, packed, pmask, device, pairs, batch * frames * 0.03,
        profile_dir, "production")
    rep.update(srep)
    results = search.traceback(state, init_log, logs, tlg.fst)
    # the same search on every frame, nothing packed out
    state0, init0 = search.init_state(batch)
    rep["unpacked_search_ms"] = timed(
        lambda: search.advance(state0, raw), device, max(pairs // 2, 1))
    ustate, ulogs = search.advance(state0, raw)
    unpacked = search.traceback(ustate, init0, ulogs, tlg.fst)
    same = sum(a["words"] == b["words"] for a, b in zip(results, unpacked))
    rep["words_packed_equal_unpacked"] = {"equal": same, "of": batch}
    rep["words_mean"] = round(float(np.mean([len(r["words"])
                                             for r in results])), 1)
    log(f"production: S={dev.num_states} B={batch} T={frames} packed {Tp} at"
        f" blank prob > 0.75 ({rep['packed_frames_at_log_0.95']} at 0.95), "
        f"K={search.beam_width}: search {rep['search_ms']['median']} ms "
        f"[{rep['search_ms']['min']}, {rep['search_ms']['max']}] "
        f"({rep['search_ms_per_frame']} ms/frame), unpacked "
        f"{rep['unpacked_search_ms']['median']} ms; words equal {same}/"
        f"{batch}; live mean {rep['live_mean']}; kf_bind {rep['kf_bind']}; "
        f"graph build {rep['graph_build_s']} + "
        f"{rep['graph_device_build_s']} s"
        f"{' (cached)' if tlg.cached else ''}, save {rep['graph_save_s']}, "
        f"load {rep['graph_load_s']}, upload {rep['graph_upload_s']} s")
    return PointRun(rep, dict(
        tlg=tlg, dev=dev, cfg_kw=cfg_kw, search=search, raw=raw,
        raw_host=raw_host, packed=packed, pmask=pmask, results=results,
        unpacked=unpacked))


# ----------------------------------------------------------------------
# realistic: single-hub trie CTC graph (kept for cross-round continuity)
# ----------------------------------------------------------------------

def realistic(device, *, pairs: int = 10, words: int = 30_000,
              batch: int = 64, frames: int = 160, beam_width: int = 1024,
              profile_dir: str | None = None, engines: bool = True
              ) -> PointRun:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.eval.synth_task import SynthTask
    from asr_decoder_tpu_torch.fst.ctc_graph import build_ctc_decode_graph
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch

    task = SynthTask(num_phones=40, num_words=words, feat_dim=24, seed=0)
    t0 = time.perf_counter()
    fst, i2p = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                      task.num_phones, share_prefixes=True)
    i2p = np.asarray(i2p, np.int32)
    dev = DeviceFst.build(fst, arc_lanes=16)
    cfg_kw = dict(beam=14.0, beam_width=beam_width, arc_lanes=16,
                  max_active=beam_width, min_active=min(200, beam_width),
                  eps_mode="closure")
    search = TorchBeamSearch(dev, i2p, DecoderConfig(**cfg_kw),
                             device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    lls = np.zeros((batch, frames, task.num_phones + 1), np.float32)
    for b in range(batch):
        while True:
            _, _, feats = task.sample_utterance(rng)
            if len(feats) <= frames:
                break
        sc = feats @ task.templates.T
        lp = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
        lls[b, :len(lp)] = lp
        lls[b, len(lp):] = lp[-1]
    ll = torch.from_numpy(lls).to(device)
    rep = _search_report(search, dev, batch, frames)
    rep.update({"graph_arcs": int(fst.num_arcs), "vocab": words,
                "posteriors": "template-softmax",
                "graph_load_s": round(load_s, 1)})
    srep, (state, init_log, logs) = _time_search(
        search, ll, None, device, pairs, batch * frames * 0.01, profile_dir,
        "realistic")
    rep.update(srep)
    results = search.traceback(state, init_log, logs, fst)
    rep["words_mean"] = round(float(np.mean([len(r["words"])
                                             for r in results])), 1)
    log(f"realistic: S={dev.num_states} B={batch} T={frames} "
        f"K={search.beam_width}: search {rep['search_ms']['median']} ms "
        f"[{rep['search_ms']['min']}, {rep['search_ms']['max']}] "
        f"({rep['search_ms_per_frame']} ms/frame); kf_bind "
        f"{rep['kf_bind']}")
    engines_rep = v2_vs_v3(dev, i2p, cfg_kw, ll, None, device, pairs) \
        if engines else None
    return PointRun(rep, dict(fst=fst, dev=dev, i2p=i2p, cfg_kw=cfg_kw,
                              search=search, ll=ll, results=results,
                              engines=engines_rep))


QUICK = {"headline": dict(batch=4, states=5_000),
         "production": dict(lm=TLG_QUICK, batch=4, frames=66,
                            beam_width=256),
         "realistic": dict(words=200, batch=4, frames=96, beam_width=128)}
POINT_FNS = {"headline": headline, "production": production,
             "realistic": realistic}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--quick", action="store_true",
                    help="every point at a small size (a smoke run)")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timed repeats per measurement, and alternating "
                         "v2/v3 pairs")
    ap.add_argument("--profile-dir", default=None,
                    help="trace a few frames per point with torch.profiler "
                         "into this directory")
    args = ap.parse_args(argv)
    device = open_device(args.device)
    # fp32 products stay fp32 on the card (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    where = device_line(device)
    log(where)
    detail: dict = {"v2_vs_v3": {}}
    for name, fn in POINT_FNS.items():
        run = fn(device, pairs=args.pairs, profile_dir=args.profile_dir,
                 **(QUICK[name] if args.quick else {}))
        detail[name] = run.report
        if run.keep.get("engines"):
            detail["v2_vs_v3"][name] = run.keep["engines"]
            log(f"{name} v2 vs v3, ms per advance, alternating pairs: "
                f"{run.keep['engines']}")
    value = detail["headline"]["audio_s_per_s"]["median"]
    print(json.dumps({
        "metric": "audio_seconds_per_second_per_gpu",
        "value": value,
        "unit": "audio-s/s",
        "vs_baseline": round(value / BASELINE_AUDIO_S_PER_S, 3),
        "device": where,
        "pairs": args.pairs,
        "timing": "wall ms between device synchronizes after a warm-up: "
                  "median, min, max over --pairs repeats",
        "detail": detail}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
