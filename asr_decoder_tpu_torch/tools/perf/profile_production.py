"""Profile the production-scale search point op by op.

Port of ``tools/perf/profile_production.py``: builds — and caches through
``DeviceFst.save/load`` — the 2,000,000-state synthetic HCLG (its ``main``)
or, with ``--tlg``, the composed TLG of the bench tool's production point
with its packed CTC-spiky posteriors (its ``main_tlg``), times one
``search.advance`` of 32 streams (88 frames at K = 4096; for the TLG the
packed 264), then runs its first 8 frames under ``torch.profiler``
and prints, per frame, the device time of the named search ranges (on
the CPU only: the card replays each frame as a captured graph, which
carries no ranges) and of the top kernels (CPU self-time on the CPU)
from ``key_averages()``, and
the device busy share against the unprofiled frame time; the Chrome trace
goes to ``--trace-dir``.

Usage: python -m asr_decoder_tpu_torch.tools.perf.profile_production
       [--device cuda|cpu] [--states S] [--batch B] [--frames T]
       [--beam-width K] [--trace-dir DIR]
       [--tlg [--beam BEAM] [--lm full|quick]]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from asr_decoder_tpu_torch.ops._build import BUILD_DIR
from asr_decoder_tpu_torch.tools.perf._common import (device_arg,
                                                      device_line, force,
                                                      open_device)
from asr_decoder_tpu_torch.utils.profiling import trace

NUM_STATES = 2_000_000
NUM_PDFS = 2048
PROFILE_FRAMES = 8      # a trace of a whole advance is 100s of MB


def build_or_load_dev(num_states: int = NUM_STATES):
    """The production graph: ``random_hclg(seed 1)`` at ``num_states``
    states, split to 8 arc lanes, ε-closure built — loaded from the
    checkout's ``build/`` when it was saved there before."""
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    path = BUILD_DIR / f"prod_graph_{num_states}.npz"
    if path.exists():
        dev = DeviceFst.load(str(path))
        print(f"loaded cached graph {path}: S={dev.num_states} "
              f"C={dev.max_closure_size}", file=sys.stderr)
        return dev
    t0 = time.perf_counter()
    fst = random_hclg(np.random.default_rng(1), num_states=num_states,
                      num_ilabels=NUM_PDFS)
    print(f"gen {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    dev = DeviceFst.build(fst, arc_lanes=8)
    dev.build_closure()
    print(f"build+closure {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    dev.save(str(tmp))
    tmp.replace(path)
    return dev


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def main(argv=None):
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--states", type=int, default=NUM_STATES)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=88)
    ap.add_argument("--beam-width", type=int, default=4096)
    ap.add_argument("--trace-dir",
                    default=str(BUILD_DIR / "profile_production"))
    ap.add_argument("--tlg", action="store_true",
                    help="the composed TLG of tools/bench.py's production "
                         "point (264 frames, packed) in place of the "
                         "synthetic HCLG")
    ap.add_argument("--beam", type=float, default=13.0,
                    help="with --tlg: the search beam")
    ap.add_argument("--lm", choices=("full", "quick"), default="full",
                    help="with --tlg: the 40k-word production LM, or the "
                         "bench tool's --quick one for a smoke run")
    args = ap.parse_args(argv)
    device = open_device(args.device)
    print(device_line(device), flush=True)
    K = args.beam_width
    B, T = args.batch, args.frames
    mask = None
    if args.tlg:
        from asr_decoder_tpu_torch.models.nnet import pack_nonblank_frames
        from asr_decoder_tpu_torch.tools import bench
        tlg = bench.build_or_load_tlg(
            bench.TLG_QUICK if args.lm == "quick" else None)
        dev, ilabel2pdf = tlg.dev, tlg.i2p
        print(f"TLG S={dev.num_states} A={dev.max_em_degree} "
              f"C={dev.max_closure_size}", file=sys.stderr)
        cfg = DecoderConfig(beam=args.beam, beam_width=K, arc_lanes=16,
                            max_active=K, min_active=min(200, K),
                            eps_mode="closure")
        ll, mask = pack_nonblank_frames(
            torch.from_numpy(bench._tlg_posteriors(
                tlg.rng, tlg.lexicon, tlg.num_phones, B, 264)).to(device),
            0, thresh=bench.BLANK_THRESH)
        T = ll.shape[1]
    else:
        dev = build_or_load_dev(args.states)
        ilabel2pdf = np.concatenate([[0], np.arange(NUM_PDFS)]).astype(
            np.int32)
        cfg = DecoderConfig(beam=14.0, beam_width=K, arc_lanes=8,
                            max_active=K, min_active=min(200, K),
                            eps_mode="closure")
        ll = torch.from_numpy(
            (np.random.default_rng(2).standard_normal((B, T, NUM_PDFS)) * 3)
            .astype(np.float32)).to(device)
    t0 = time.perf_counter()
    search = TorchBeamSearch(dev, ilabel2pdf, cfg, device=device)
    print(f"upload/search init {time.perf_counter() - t0:.1f}s; "
          f"mode={search.mode} relax={search.relax_impl} "
          f"stages={search.num_stages} C={dev.max_closure_size}",
          file=sys.stderr)
    st, _ = search.init_state(B)

    def run():
        return force(search.advance(st, ll, mask)[0])

    run()                                                # warm-up
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"advance wall {wall * 1e3:.1f} ms ({wall / T * 1e3:.2f} ms/frame)"
          f" on {device.type}; {B * T / wall:.1f} stream-frames/s")
    # the profiler's own cost stretches the wall, so profile a few frames
    # and hold their device time to the unprofiled ms/frame above
    F = min(PROFILE_FRAMES, T)
    with trace(args.trace_dir) as prof:
        force(search.advance(st, ll[:, :F],
                             None if mask is None else mask[:, :F])[0])
    report(prof, F, device.type == "cuda", wall / T * 1e3)
    print(f"Chrome trace in {args.trace_dir}/trace.json")


def report(prof, frames: int, on_card: bool, frame_ms: float) -> dict:
    """Per-frame times of a profile of ``frames`` search frames: the total
    device kernel time (CPU op self-time off the card) and its share of the
    unprofiled ``frame_ms``, the named search ranges (on the card: their
    span from first to last kernel, gaps included), the top kernels.
    Printed, and returned in short (ms and ops a frame, the busy share,
    the top five kernels)."""
    key = _device_us if on_card else (lambda e: e.self_cpu_time_total)
    events = prof.key_averages()
    ranges = [e for e in events if getattr(e, "is_user_annotation", False)
              and key(e) > 0]
    ops = [e for e in events if not getattr(e, "is_user_annotation", False)
           and (not on_card or e.device_type == DeviceType.CUDA)]
    total = sum(key(e) for e in ops) / 1e3 / frames
    launches = sum(e.count for e in ops) / frames
    what = "device kernel" if on_card else "CPU op self"
    print(f"\nprofiled {frames} frames; {what} time {total:.3f} ms/frame, "
          f"{launches:.0f} ops/frame"
          + (f"; {100 * total / frame_ms:.1f}% of the unprofiled "
             f"{frame_ms:.3f} ms/frame (device busy share)"
             if on_card else ""))
    for e in sorted(ranges, key=key, reverse=True):    # idle gaps included
        print(f"range {e.key:14s} {key(e) / 1e3 / frames:9.3f} ms/frame "
              f"span under the profiler")
    ranked = sorted(ops, key=key, reverse=True)
    for e in ranked[:45]:
        print(f"{key(e) / 1e3 / frames:9.4f} ms/frame  "
              f"x{e.count / frames:<7.1f} {e.key[:100]}")
    return {"frames": frames, "on_card": on_card,
            "ms_per_frame": round(total, 4),
            "ops_per_frame": round(launches, 1),
            "busy_share": round(total / frame_ms, 4) if on_card else None,
            "top": [{"name": e.key[:80],
                     "ms_per_frame": round(key(e) / 1e3 / frames, 4),
                     "per_frame": round(e.count / frames, 1)}
                    for e in ranked[:5]]}


if __name__ == "__main__":
    main()
