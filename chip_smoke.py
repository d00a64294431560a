#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the streaming-serve
path, the v2 search engine, the ``tools/perf`` row-gather microbenches, the
graph types, the VAD-driven serve path, the offline decode, eval and
CTC-training path, and the multi-device and native host paths.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``asr_decoder_tpu_torch`` from the
sources in this checkout, then:

  1. reports the card (name; ``nvidia-smi`` name and power limit);
  2. checks each search kernel bit-exactly against its plain PyTorch
     version at the main path's shapes (``GATHER_CASES``, the gather's
     multi-table form included, and ``FETCH_CASES``, full and mixed live
     counts) and times it beside its bound (the bytes the data needs at
     3.35 TB/s), the plain version, the library call and the launch floor
     (an empty kernel in the same graph harness); then the traceback
     kernel, which replaces the host walk and no TPU kernel, bit-exactly
     against its plain version at the offline cells' shapes
     (``TRACEBACK_CASES``) and timed beside its latency-chain bound (its
     dependent reads at an L2 round trip, timed by a pointer chase);
  3. checks the row-gather counterparts of the three ``tools/perf`` TPU
     kernels (``make_dma_gather``, ``make_dma``, ``make_dma_dyn``) bit-
     exactly against their plain version at the JAX tools' shapes (2M-row
     tables, 131,072 indices, 128-512 lanes, live counts 131,072 / 32,768
     / 8,192), times each in ``ROW_PAIRS`` alternating pairs with its
     library call, beside its bound and the copy ceiling (a contiguous
     device-to-device copy of the same bytes), and its plain version,
     drives each once through its tool's chained calls, counting the
     kernel's launches there, and runs each tool's bench;
  4. decodes fixed loglikes through the full-size search (200k-state graph,
     K=512, B=16) on the card and on the CPU — the v3 engine, then the v2
     engine in closure and in sweeps ε mode: logs, words and costs must be
     bit-identical (every search op is an exact fp32 add/compare, gather or
     sort), the gather kernel must launch in each v2 run, and a v3 frame
     makes exactly ``V3_GATHERS_PER_FRAME`` gather launches.  Each search
     runs every live frame as one replay of a captured CUDA graph
     (``utils/cuda_graphs.py``); a "graphs" line a search holds it against
     the eager frame loop on the card (each runner's body called directly,
     ``eager_graphs``) over ``GRAPH_FRAMES`` frames with a dead frame and a
     partly masked row: beam, logs and snapshots bit-identical, kernel
     launches equal, then ms/frame of each in ``GRAPH_PAIRS`` alternating
     pairs, host-issued CUDA calls (launches, copies, fills) a frame and
     the card's busy share (profiler device ms over wall ms);
  5. runs the full-width flagship AM on the card and on the CPU
     (allclose, ``AM_ATOL``: the products sum in another order), then a
     "graphs" line for the AM chunk as ``OnlineDecoderInfo.score`` runs it
     (``GraphedAm``, [BATCH, ``AM_CHUNK``, 240] from a mid-stream carry):
     log-likelihoods and carries bit-identical graph against eager, ms a
     chunk in alternating pairs, host calls and busy share;
  6. serves 16 concurrent 4-second utterances through the port's
     ``AsrServer`` built by its CLI loader, and checks every final reply
     against an in-process ``BatchedStreamingDecoder`` on the same waves,
     and that both kernels launched during the serve run; then that
     arena's results: every channel's word alignment and lattice, and
     ``SESSION_UTTS`` of the waves decoded in lone card sessions, whose
     alignments and 3-best texts the arena's channels must equal; then the
     two entry points a user starts, over the same files and flags:
     ``cli.decode`` on ``CLI_UTTS`` of the waves written as wav files, each
     utterance's words equal to a lone card session's over the whole wave
     (%WER 0.00 against those words), both kernels then held bit-exactly
     to their plain versions at every shape the CLI launched them at, and
     ``cli.serve`` in a subprocess on a port the system picks
     (``--port=0``), listening within ``CLI_START_S``, streamed
     ``CLI_SERVE_UTTS`` of the waves at once through ``serving/client.py``,
     their final texts equal to the decode CLI's, then terminated;
  7. graph types: the ``clg`` search (a 200k-state CLG layer over 2000
     three-state HMMs) and the ``biglm-hclg`` search (the 200k-state graph
     with the difference of a 20k-bigram and a 200k-bigram + 100k-trigram
     LM, ``lm_lanes`` 1024, so the compaction runs): the gather kernel
     bit-exact against its plain version at their table shapes,
     ``GT_FRAMES`` frames of fixed loglikes decoded on the card and on the
     CPU with bit-identical logs,
     LM lanes, overflow flags, words and costs, the BigLM compaction one
     gather launch for its seven operands, a "graphs" line each as in
     phase 4, then 8 concurrent utterances
     of ``GT_SECONDS`` served (``clg`` through the CLI loader's
     ``--hmmfst-file``), every reply equal to the in-process batcher, the
     gather kernel launching in each run;
  8. the VAD-driven serve path: the flagship AM reading 80 fbank + 3 pitch
     features over the 200k-state graph with ``use_energy_vad`` (endpoint
     after 50 silent frames, not before 30 decoded); 8 concurrent clients
     each stream speech, >= 1 s of silence below ``energy_threshold1`` and
     speech, in 0.1-0.25 s pushes: every stream gets a ``MIDDLEEND``, its
     replies carry the finished segments' words before the live one's, and
     all equal per-stream ``OnlineDecoderSession``s on the card (endpoint
     pushes, segment words); the search kernels launch.  Then card against
     CPU: energy-VAD decisions exactly, streamed pitch features within
     ``PITCH_TOL`` with equal Viterbi lag paths (2 short streams),
     ``V1AsrSession`` segments and frames fed to the AM exactly (2
     streams), ``VadNnetStream`` decisions exactly, ``WakeupSearch`` firing
     and the DTW costs within ``DTW_TOL``; it prints the phase's wall time
     and RTF, pitch ms per push at 1 s and at the end of a stream, VAD ms
     per push, the pitch Viterbi's kernels per push, and the wall time
     from the first silent push to its ``MIDDLEEND`` reply;
  9. offline, through ``tools/bench.py``'s point functions and
     ``tools/eval.py``: the headline point at full width (256 waves of 8 s
     → fbank → the 1024/512/3 flagship → v3 search over the 200k-state
     graph), its first ``OFFLINE_ROWS`` rows held to a CPU AM run
     (``AM_ATOL``) and to a CPU search fed the card's log-likelihoods
     (words and costs bit-identical); the production point over the
     composed TLG built by ``fst/tlg.py`` (in a second process started with
     the script, so the host build overlaps the earlier phases): the
     ``DeviceFst`` save/load round trip equal, packing on the card equal to
     packing on the CPU, the card search equal to the CPU search on
     ``PROD_ROWS`` rows, packed against unpacked words; the realistic
     point, its first ``PROD_ROWS`` rows held to a CPU search; the eval
     tool at its quick size trained and decoded on the card (no gold
     mismatch, WER under ``EVAL_WER``; its training steps are graph
     replays, and its AM, ``GraphedAm``, is held bit for bit to an eager
     rerun of the same decode); ``TRAIN_STEPS`` CTC training steps of the
     full-width flagship on the card and on the CPU from the same weights,
     each loss within ``TRAIN_RTOL``, then two steps at ``INFEASIBLE_T``
     frames whose second batch holds a row whose labels cannot fit its
     frames (its card loss, a replay, finite and within ``TRAIN_RTOL`` of
     the CPU's); a "graphs train" line: three flagships from one seed,
     one stepped through the captured training graph and two eagerly
     (``eager_graphs``) on the same ``TRAIN_GRAPH_BATCHES`` batches, the
     graph's losses and parameters after every step as close to the first
     eager model's as the second eager model's are (bit for bit where those
     two are), the search kernels' counters unmoved, ms a step in
     alternating pairs, host calls, device ms, the card's busy share and
     the CTC loss's share of the step's device time.  Both search kernels must
     launch at each of the three points and in the eval run, and after
     each of those runs both are held bit-exactly to their plain versions
     at every shape that run launched them at (the wrappers record the
     shapes while ``counted`` asks them to).  The times it prints (medians
     of ``OFFLINE_REPEATS`` repeats) are smoke figures;
 10. multi-device on the one card (a mesh whose entries repeat ``cuda:0``)
     and the native host paths: phase 4's loglikes decoded by
     ``parallel/decode.py:dp_decode`` at dp = 2 and 4, every leaf bit-
     identical to the unsharded card decode, with the ms/frame and kernel
     launches of dp = 1/2/4 (each mesh warmed first); ``UTTS`` 4-s streams
     through the dp = 2 arena (``BatchedStreamingDecoder(mesh=...)``), words
     and arc ids equal to the unsharded arena, costs within
     ``ARENA_COST_RTOL`` of their size, beside the AM's rows 0-7 computed
     alone against the same rows of the 16-row call on the card and on the
     CPU (the cause of the costs' last bits); phase 7's BigLM
     search at dp = 2, bit-identical with equal overflow counts; both
     kernels bit-exact against their plain versions at every shape those
     runs launched; the full-width flagship with its affine rows split
     over tp = 2, within ``AM_ATOL`` of the unsharded AM and decoding to the
     same words; two simulated hosts' arenas equal to per-stream sessions,
     the second unaffected when the first is dropped, and the one-rank NCCL
     selftest (``MH_OK``, started once the timed runs are done);
     ``native_nbest.available()``, the native n-best equal to the Python one
     (n = ``NBEST_N``) on the determinized lattices of ``NATIVE_UTTS`` of
     phase 6's utterances, timed both ways as the session and batcher reach
     it (``nbest_from_lattice``, the lattice's serialization included) and
     as the post service does (on the bytes it makes for its reply); the C++
     client (``NativeAsrClient``) against the Python client through the
     port's server, texts and word alignments equal; the dry run
     ``parallel/dryrun.py:dryrun_multichip(4)`` (dp 2 × tp 2).

Any failed check raises, so the script exits non-zero; it never falls back
to the CPU.  Its last two lines are the kernels' JSON record (the five TPU
kernels: the gather with its launches in the serve, decode CLI,
graph-types, VAD serve and offline runs, the fetch with its launches in the
serve, decode CLI, VAD serve and offline runs,
the three microbench row gathers with their tool-path launches, each with
its bound and library time; the search kernels' launches include
phase 10's dp decodes, dp arena and BigLM dp decode; then the traceback
kernel with its launches in the offline runs, one a batch, where the
serve runs and the decode CLI, whose logs are host copies, launch none)
and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package ``asr_decoder_tpu`` (the port keeps its own copies of
the host modules), which it checks at the end of the run.
"""

from __future__ import annotations

import asyncio
import copy
import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

# the slice: bench headline model and search config
FEAT_DIM, NUM_PDFS, SKIP = 80, 2048, 2
GRAPH_STATES, ARC_LANES = 200_000, 8
SEARCH = dict(beam=14.0, beam_width=512, arc_lanes=ARC_LANES, max_active=512,
              min_active=16, eps_mode="closure")
BATCH, FRAMES = 16, 133            # 4 s of audio after 3x subsampling
V2_FRAMES = 67                     # the two v2 runs of phase 4: 2 s
UTTS, UTT_SECONDS, CHUNK = 16, 4.0, 3200
SESSION_UTTS = 4                   # served waves re-decoded in lone sessions
CLI_UTTS, CLI_SERVE_UTTS = 4, 2    # waves through cli.decode, cli.serve
CLI_START_S = 300.0                # cli.serve must listen within this
CLI_REPLY_S = 300.0                # and answer its streams within this
AM_ATOL = 1e-3                     # log-likelihood units
# phase 2: the gather at the main path's shapes — (B, V, N, tables P,
# label): the v3 relax tables at B=32, the acoustic lookup at the headline
# point (B=256), the production relax (K=4096, F=2), and the multi-table
# form at P = 2 (a backpointer pair), 3 (the relax winners) and 7 (the
# BigLM compaction); then shapes of the offline points (phase 9 holds
# the kernel at every shape those runs launch it at, untimed)
GATHER_CASES = [(32, 2048, 4096, 1, ""), (32, 4096, 1024, 1, ""),
                (32, 2560, 1024, 1, ""), (32, 1024, 512, 1, ""),
                (32, 512, 512, 1, ""), (32, 65536, 4096, 1, ""),
                (256, 2048, 4096, 1, " (headline acoustic)"),
                (32, 32768, 8192, 1, " (production relax)"),
                (32, 8192, 4096, 1, " (production relax)"),
                (16, 1024, 512, 2, " (v3 closure winners)"),
                (16, 1024, 512, 3, " (v3 emit winners)"),
                (16, 4096, 4096, 7, " (biglm compaction)"),
                (256, 4096, 1024, 1, " (headline relax)"),
                (256, 1024, 512, 3, " (headline winners)"),
                (32, 41, 65536, 1, " (production acoustic)"),
                (64, 41, 16384, 1, " (realistic acoustic)"),
                (64, 16384, 2048, 1, " (realistic relax)")]
# the fetch: (rows S, lanes L, [(B, K)]) — the smoke graph, the
# production-size table at the search's 32, 64 and 128-lane records, and
# the realistic point's trie
FETCH_SHAPES = [(16, 512), (256, 512), (32, 4096)]
FETCH_CASES = [(200_001, 32, FETCH_SHAPES), (2_500_000, 32, FETCH_SHAPES),
               (2_500_000, 64, FETCH_SHAPES), (2_500_000, 128, FETCH_SHAPES),
               (54_770, 64, [(64, 1024)])]
# the traceback kernel at the offline cells' shapes — (B, K, frames,
# beam, min_active, cell) — over a random HCLG of TRACEBACK_STATES states;
# its bound's yardstick chases CHASE_STEPS dependent reads through a cycle
# over CHASE_HBM words after a CHASE_FLUSH-byte write (device memory) and
# over CHASE_L2 words after the same walk (the L2), CHASE_REPS times
TRACEBACK_CASES = [(256, 512, 267, 14.0, 16, "hclg200k.offline"),
                   (32, 4096, 264, 12.0, 200, "tlg2m.offline")]
TRACEBACK_STATES = 50_000
# the served arena's walk and store write (B, K, frames a row, rows a
# round, rows a tick, frames a tick): hclg200k.flood's shapes
SERVED_CASE = (256, 512, 700, 124, 21, 32)
CHASE_STEPS, CHASE_HBM, CHASE_L2 = 20_000, 1 << 26, 1 << 20
CHASE_FLUSH, CHASE_REPS = 256 << 20, 5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, published peak
V3_GATHERS_PER_FRAME = 7           # phase 4: emit 5 + closure 2
# the tools/perf row-gather microbenches (JAX tools' shapes)
ROW_S, ROW_NIDX, ROW_WIDTHS = 2_000_000, 131_072, (128, 256, 512)
ROW_PAIRS = 10                     # kernel/library pairs of each row gather
ROW_SETS = 16                      # index sets a timed loop cycles through
ROW_LIVE = (131_072, 32_768, 8_192)
# phase 7, the graph types: the CLG layer and its HMMs, the BigLM's LMs
CLG_HMMS = 2000
LM_VOCAB = 5000
LM1 = dict(vocab_size=LM_VOCAB, n_bigram=20_000, seed=11)
LM2 = dict(vocab_size=LM_VOCAB, n_bigram=200_000, n_trigram=100_000,
           seed=12)
GT_UTTS, GT_SECONDS = 8, 2.0        # the served run of each graph type
GT_FRAMES = 34                     # card-vs-CPU decode: 1 s after subsampling
PROFILE_FRAMES = 4                 # frames profiled for kernels/frame
# the graph-vs-eager lines of phases 4, 5 and 7: each search over
# GRAPH_FRAMES frames with frame GRAPH_DEAD masked in every row and row
# GRAPH_ROW masked from GRAPH_ROW_LEN on; the AM over one served chunk
GRAPH_FRAMES, GRAPH_DEAD, GRAPH_ROW, GRAPH_ROW_LEN = 34, 5, 3, 20
GRAPH_PAIRS = 10                   # alternating graph/eager timing pairs
AM_CHUNK = 32                      # the serve path's chunk_frames
# phase 8, the VAD-driven serve path
PITCH_DIM = 3                      # POV, normalized log pitch, delta pitch
VAD_STREAMS = 8
SIL_S = 1.2                        # silence between the two speech parts
PUSH_SAMPLES = (1600, 4000)        # 0.1-0.25 s pushes
CPU_STREAMS = 2                    # streams of the pitch and V1 CPU runs
PITCH_TOL = 1e-4                   # atol = rtol, the CPU tests' tolerance
DTW_TOL = 1e-5                     # atol = rtol: fp32 cumsums in another order
# phase 9, the offline decode, eval and training path
OFFLINE_REPEATS = 3                # timed repeats a measurement (smoke)
OFFLINE_ROWS, PROD_ROWS = 8, 4     # rows held to the CPU
EVAL_STEPS, EVAL_WER = 600, 0.2    # the eval tool's quick task
TRAIN_STEPS, TRAIN_B, TRAIN_T, TRAIN_L = 3, 16, 96, 24
TRAIN_RTOL = 1e-3                  # card loss against CPU loss, relative
INFEASIBLE_T = 16                  # frames of the batch whose row 0 holds
                                   # TRAIN_L > INFEASIBLE_T labels
TRAIN_GRAPH_BATCHES = 11           # the first captures; then GRAPH_PAIRS pairs
# phase 10, multi-device on one card and the native host paths
DP_MESHES = (2, 4)                 # dp sizes of the dp decode (["cuda:0"]*dp)
NATIVE_UTTS, NBEST_N = 4, 10       # phase 6 utterances held native == Python
ARENA_COST_RTOL = 1e-5             # dp arena path costs, of |cost|: the AM at B/dp
                                   # rows (6.5e-6 read on the H100)
NCCL_TIMEOUT_S = 240.0             # the one-rank NCCL selftest's wall limit


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def check_imports() -> None:
    """No module of jax and none of the JAX package ``asr_decoder_tpu`` was
    loaded: the port runs on its own copies of the host modules."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "asr_decoder_tpu"))
    check(not bad, f"jax or JAX-package modules loaded: {bad}")
    print("imports: no jax and nothing of asr_decoder_tpu")


def time_ms(fn, calls: int = 20, replays: int = 20) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn``.  Device: ``calls`` calls
    captured in one CUDA graph and replayed, so the host's launch cost is
    left out.  Wall: back-to-back eager calls timed with CUDA events, which
    at these sizes is set by the host's launch path."""
    from asr_decoder_tpu_torch.tools.perf._common import time_loop
    wall, device = time_loop(lambda: [fn() for _ in range(calls)],
                             torch.device("cuda", 0), calls, replays)
    return device, wall


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def bound_ms(nbytes: float) -> float:
    """The least time to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def launch_floor_ms() -> float:
    """Device time of an empty kernel (``torch.cuda._sleep(0)``: one thread,
    no work) in the same graph harness: the floor under every kernel."""
    return time_ms(lambda: torch.cuda._sleep(0))[0]


def gather_exact(gen, dev, B: int, V: int, N: int, types) -> tuple:
    """Random [B, V] tables of ``types`` and one random [B, N] index through
    the gather kernel and its plain version: bit-exact.  Returns (tables,
    idx, max abs err)."""
    from asr_decoder_tpu_torch.ops import gather
    tables = []
    for t in types:
        if t == torch.float32:
            tables.append(torch.randn((B, V), generator=gen, device=dev))
        else:
            tables.append(torch.randint(-2**31, 2**31 - 1, (B, V),
                                        generator=gen, device=dev,
                                        dtype=torch.int32))
    idx = torch.randint(0, V, (B, N), generator=gen, device=dev,
                        dtype=torch.int32)
    got = gather.batched_table_gather_many(tables, idx)
    want = gather.gather_plain_many(tables, idx)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
              f"gather [{B},{V}]x[{B},{N}] {types} bit-exact")
        err = max(err, (g.double() - w.double()).abs().max().item())
    return tables, idx, err


def gather_case(gen, dev, B: int, V: int, N: int, dtype, label: str = "",
                P: int = 1, floor: float = 0.0) -> dict:
    """The gather kernel on P random [B, V] tables sharing one [B, N] index
    (P = 1: one table of ``dtype``; P > 1: f32 and i32 tables in turn)
    against its plain version, bit-exact, and timed beside its bound, the
    plain version and the library call (``torch.gather`` with the index
    cast to int64 outside the timed region; P calls for P tables).  Prints
    one row; returns its numbers."""
    from asr_decoder_tpu_torch.ops import gather
    types = [dtype] if P == 1 else [(torch.float32, torch.int32)[p % 2]
                                    for p in range(P)]
    tables, idx, err = gather_exact(gen, dev, B, V, N, types)
    idx64 = idx.long()
    ms, wms = time_ms(lambda: gather.batched_table_gather_many(tables, idx))
    pms, pwms = time_ms(lambda: gather.gather_plain_many(tables, idx))
    lms, _ = time_ms(lambda: [torch.gather(t, 1, idx64) for t in tables])
    # bytes: the table words this index touches (each read once), the
    # index, the outputs
    rows = torch.arange(B, device=dev)[:, None] * V
    touched = torch.unique(idx.long() + rows).numel()
    bms = bound_ms(4 * (P * touched + B * N + P * B * N))
    name = str(dtype)[6:] if P == 1 else f"P={P}"
    print(f"gather  [{B},{V}]x[{B},{N}] {name}{label}: device kernel "
          f"{ms:.4f} ms, bound {bms * 1e3:.3f} us ({bms / ms:.1%}), plain "
          f"{pms:.4f} ms, library {lms:.4f} ms, launch floor {floor:.4f} "
          f"ms; per eager call kernel {wms:.4f} ms plain {pwms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by="bytes")


def fetch_exact(table, state, lives) -> float:
    """The fetch kernel against its plain version on ``state`` [B, K] at
    each live-count vector of ``lives``: bit-exact on the live rows.
    Returns the max abs err."""
    from asr_decoder_tpu_torch.ops import fetch
    (S, L), (B, K) = table.shape, state.shape
    err = 0.0
    for live in lives:
        rows_live = (torch.arange(K, device=table.device)[None, :]
                     < live[:, None])
        want = fetch.fetch_plain(table, state)[rows_live]
        got = fetch.fetch_records(table, state, live)[rows_live]
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"fetch [{S},{L}] B={B} K={K} live rows bit-exact")
        if got.numel():
            err = max(err, (got.double() - want.double()).abs().max().item())
    return err


def mixed_live(B: int, K: int, dev) -> torch.Tensor:
    """Live counts 0, K, K/3, 1 a row in turn."""
    return torch.tensor([[0, K, K // 3, 1][b % 4] for b in range(B)],
                        dtype=torch.int32, device=dev)


def fetch_cases(gen, dev, S: int, L: int, shapes, floor: float) -> dict:
    """The fetch kernel on one random [S, L] table at each (B, K) of
    ``shapes``, with every live and with mixed live counts (0, K, K/3, 1 a
    row in turn): bit-exact against the plain version on the live rows,
    and timed beside the bound, the plain version, the library call
    (``torch.index_select`` over pre-clamped states, which reads every B·K
    row) and the launch floor.
    Timed calls cycle through 64 index sets: at 2.5M rows the rows they
    touch overflow the 50 MB L2, as the production graph's would; the 200k
    table fits the L2 whole.  Returns {(B, K): numbers, full live}."""
    from asr_decoder_tpu_torch.ops import fetch
    table = torch.randint(-2**31, 2**31 - 1, (S, L), generator=gen,
                          device=dev, dtype=torch.int32)
    out = {}
    for B, K in shapes:
        states = [torch.randint(0, S, (B, K), generator=gen, device=dev,
                                dtype=torch.int32) for _ in range(64)]
        flat = [s.view(-1).clamp(0, S - 1) for s in states]
        full = torch.full((B,), K, dtype=torch.int32, device=dev)
        mixed = mixed_live(B, K, dev)
        err = fetch_exact(table, states[0], (full, mixed))
        it = iter(range(1 << 30))
        rec = dict(max_abs_err=err)
        for live, tag in ((full, "full"), (mixed, "mixed")):
            # bytes: live[b] and the live states, each distinct live row
            # read once, each live output row written once
            alive = (torch.arange(K, device=dev)[None, :] < live[:, None])
            nlive = int(alive.sum())
            rows = torch.unique(states[0][alive].clamp(0, S - 1)).numel()
            bms = bound_ms(4 * B + 4 * nlive + 4 * L * (rows + nlive))
            ms = time_ms(lambda: fetch.fetch_records(
                table, states[next(it) % 64], live), calls=64,
                replays=5)[0]
            print(f"fetch   [{S},{L}] B={B} K={K} live {tag} ({nlive} "
                  f"rows): device kernel {ms:.4f} ms, bound "
                  f"{bms * 1e3:.3f} us ({bms / ms:.1%})")
            if tag == "full":
                rec.update(ms=ms, bound_ms=bms, bound_by="bytes")
        pms, pwms = time_ms(lambda: fetch.fetch_plain(
            table, states[next(it) % 64]), calls=64, replays=5)
        lms, _ = time_ms(lambda: torch.index_select(
            table, 0, flat[next(it) % 64]), calls=64, replays=5)
        wms = time_ms(lambda: fetch.fetch_records(
            table, states[next(it) % 64], full), calls=64, replays=5)[1]
        print(f"fetch   [{S},{L}] B={B} K={K}: plain {pms:.4f} ms, library "
              f"{lms:.4f} ms, launch floor {floor:.4f} ms; per eager call "
              f"kernel {wms:.4f} ms plain {pwms:.4f} ms")
        rec.update(plain_ms=pms, library_ms=lms)
        out[(B, K)] = rec
        del states, flat
    del table
    return out


def chase_us(dev) -> tuple[float, float]:
    """us a dependent read, through device memory and through the L2: one
    thread follows a random cycle (``csrc/traceback.cu``'s chase kernel)
    ``CHASE_STEPS`` reads from word 0, over ``CHASE_HBM`` words with the
    L2 flushed just before (a write of ``CHASE_FLUSH`` bytes), and over
    ``CHASE_L2`` words just after the same walk left its lines in the L2.
    The clocks are warmed first by ~0.3 s of matrix products; each is the
    least of ``CHASE_REPS`` timings, the two taken in turn."""
    import ctypes
    from asr_decoder_tpu_torch.ops._build import load_library
    fn = load_library("traceback").traceback_chase_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(5)

    def cycle(words):
        order = torch.randperm(words, generator=gen, device=dev)
        nxt = torch.empty(words, dtype=torch.int32, device=dev)
        nxt[order] = order.roll(-1).to(torch.int32)
        return nxt
    bufs = {"hbm": cycle(CHASE_HBM), "l2": cycle(CHASE_L2)}
    flush = torch.empty(CHASE_FLUSH, dtype=torch.uint8, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(nxt, steps):
        check(fn(nxt.data_ptr(), steps, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream) == 0,
              "chase kernel launched")

    def timed(nxt):
        start.record()
        run(nxt, CHASE_STEPS)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / CHASE_STEPS
    a = torch.randn((4096, 4096), generator=gen, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.3:
        (a @ a).sum().item()
    del a
    best = {"hbm": float("inf"), "l2": float("inf")}
    for _ in range(CHASE_REPS):
        flush.fill_(1)
        best["hbm"] = min(best["hbm"], timed(bufs["hbm"]))
        run(bufs["l2"], CHASE_STEPS)
        best["l2"] = min(best["l2"], timed(bufs["l2"]))
    check(best["hbm"] > 1.5 * best["l2"],
          f"chase: the device-memory read ({best['hbm']:.4f} us) clearly "
          f"above the L2's ({best['l2']:.4f} us)")
    return best["hbm"], best["l2"]


def traceback_cases(dev, floor: float) -> dict:
    """The traceback kernel at the offline cells' shapes
    (``TRACEBACK_CASES``), on the logs of a search over a random HCLG with
    padded rows: bit-exact against its plain version (each row's length,
    cost, final flag and arcs), timed (device time in the graph harness,
    and an eager call) beside its latency-chain bound (S·T + 9 dependent
    reads a row, each an L2 round trip, every row in flight at once), the
    same chain at the device-memory round trip, the plain version's wall
    time and the launch floor.  Returns the numbers of the hclg200k
    shape."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    from asr_decoder_tpu_torch.ops import traceback as tb
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    hbm, l2 = chase_us(dev)
    print(f"chase: a dependent read {hbm:.4f} us through "
          f"{CHASE_HBM * 4 >> 20} MB after an L2 flush (device memory), "
          f"{l2:.4f} us through {CHASE_L2 * 4 >> 20} MB warm (the L2); "
          f"the least of {CHASE_REPS} each")
    dfst = DeviceFst.build(random_hclg(np.random.default_rng(17),
                                       num_states=TRACEBACK_STATES,
                                       num_ilabels=NUM_PDFS - 1),
                           arc_lanes=ARC_LANES)
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for B, K, T, beam, min_active, cell in TRACEBACK_CASES:
        search = TorchBeamSearch(
            dfst, np.arange(NUM_PDFS, dtype=np.int32),
            DecoderConfig(beam=beam, beam_width=K, max_active=K,
                          min_active=min_active, arc_lanes=ARC_LANES,
                          eps_mode="closure", relax_impl="topk"),
            device=dev)
        ll = 3 * torch.randn((B, T, NUM_PDFS), generator=gen, device=dev)
        lens = torch.randint(T // 2, T + 1, (B,), generator=gen, device=dev)
        lens[0] = T
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        state, init_log, logs = search.decode(ll, mask)
        tables = tb.walk_tables(dfst, search.A, search.C, dev)
        args = (tables, state.tok_state, state.tok_cost, logs.prev_slot,
                logs.arc_id, logs.tok_state, init_log.prev_slot,
                init_log.arc_id, init_log.tok_state)
        got = tb.best_paths(*args).cpu()
        t0 = time.perf_counter()
        want = tb.best_paths_plain(*args).cpu()
        pms = (time.perf_counter() - t0) * 1e3
        n = want[:, tb.LENGTH].clamp(min=0)
        check(bool((n > 0).all()) and all(
            torch.equal(g[:tb.HEAD + k], w[:tb.HEAD + k])
            for g, w, k in zip(got, want, n.tolist())),
            f"traceback [{cell}] B={B} K={K} T={T}: kernel == plain")
        ms, wms = time_ms(lambda: tb.best_paths(*args), calls=20, replays=5)
        S = logs.prev_slot.shape[1]
        chain = S * T + 9
        bms = chain * l2 * 1e-3
        copy_gb = (2 * logs.prev_slot.numel() + logs.tok_state.numel()) \
            * 4 / 1e9
        print(f"traceback [{cell}] B={B} K={K} T={T} S={S}: kernel == "
              f"plain bit for bit ({int(want[:, tb.FINAL].sum())} of {B} "
              f"rows reach the final state, paths {int(n.min())}-"
              f"{int(n.max())} arcs); device kernel {ms:.4f} ms, latency-"
              f"chain bound {bms:.4f} ms ({chain} dependent reads at the "
              f"L2's {l2:.4f} us; {bms / ms:.1%}), the chain at device "
              f"memory's {hbm:.4f} us {chain * hbm * 1e-3:.4f} ms; plain "
              f"{pms:.1f} ms (wall), launch floor {floor:.4f} ms; per "
              f"eager call {wms:.4f} ms; the host walk's copy {copy_gb:.3f}"
              f" GB")
        out[cell] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by="latency", library_ms=None)
        del search, state, init_log, logs, args, ll
    served_cases(dev, dfst, gen, hbm, l2)
    return out["hclg200k.offline"]


def events_ms(fn, calls: int = 20) -> float:
    """Device-stream ms per eager call of ``fn`` (CUDA events around
    ``calls`` back-to-back calls, after one warm call)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


@torch.inference_mode()
def served_cases(dev, dfst, gen, hbm: float, l2: float) -> None:
    """The served arena's two entries of ``csrc/traceback.cu`` at
    ``hclg200k.flood``'s shapes (``SERVED_CASE``): the round's walk of
    ``rows`` rows of a 256-row store, each over its own frames (log-normal
    lengths, median 200 frames, as the flood's utterances), bit-exact
    against the plain version on the card, timed beside its latency-chain
    bound (S·T + 9 dependent reads of the longest row, at the L2's and at
    device memory's round trip: the store is past the L2); the tick's
    store write of ``adv`` rows, bit-exact and timed beside its bytes at
    HBM bandwidth (each word read once and written once)."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.ops import traceback as tb
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    from asr_decoder_tpu_torch.serving.logstore import PAGE_FRAMES
    B, K, T, rows_n, adv, F = SERVED_CASE
    search = TorchBeamSearch(
        dfst, np.arange(NUM_PDFS, dtype=np.int32),
        DecoderConfig(beam=14.0, beam_width=K, max_active=K, min_active=16,
                      arc_lanes=ARC_LANES, eps_mode="closure",
                      relax_impl="topk"), device=dev)
    ll = 3 * torch.randn((B, T, NUM_PDFS), generator=gen, device=dev)
    state, init_log, logs = search.decode(ll)
    rng = np.random.default_rng(23)
    rows = rng.choice(B, rows_n, replace=False)
    lengths = np.clip(rng.lognormal(np.log(200), 0.5, rows_n), 50,
                      T).astype(np.int64)
    lengths[0] = T
    tables = tb.walk_tables(dfst, search.A, search.C, dev)
    # the logs in the store's pages (serving/logstore.py), each row's pages
    # drawn at random from the pool
    P = PAGE_FRAMES
    M = -(-T // P)
    pages = rng.permutation(B * M).reshape(B, M).astype(np.int32)
    t = np.arange(T)
    g = torch.from_numpy(pages[:, t // P].astype(np.int64) * P
                         + t % P).to(dev)                       # [B, T]
    pool = []
    for a in logs:
        leaf = a.new_empty((B * M, P, *a.shape[1:-2], K))
        flat = leaf.view(-1, *leaf.shape[2:])
        flat[g.t()] = a.movedim(-2, 1) if a.dim() == 4 else a
        pool.append(leaf)
    args = (tables, state.tok_state, state.tok_cost, *pool[:3],
            init_log.prev_slot[:, :1], init_log.arc_id[:, :1],
            init_log.tok_state[:1], pages)
    got = tb.best_paths_rows(*args, rows, lengths).cpu()
    r = torch.from_numpy(rows).to(dev)
    n, Tm = len(rows), int(lengths.max())
    t0 = time.perf_counter()
    want = tb.best_paths_plain(
        tables, state.tok_state[r], state.tok_cost[r], logs.prev_slot[:Tm,
                                                                      :, r],
        logs.arc_id[:Tm, :, r], logs.tok_state[:Tm, r],
        *(a.expand(a.shape[0], n, K) for a in args[6:8]),
        args[8].expand(n, K), lengths=torch.from_numpy(lengths)).cpu()
    pms = (time.perf_counter() - t0) * 1e3
    k = want[:, tb.LENGTH].clamp(min=0)
    check(bool((k > 0).all()) and got.shape == want.shape and all(
        torch.equal(g[:tb.HEAD + m], w[:tb.HEAD + m])
        for g, w, m in zip(got, want, k.tolist())),
        f"traceback rows [hclg200k.flood] {n} of {B} rows: kernel == plain")
    ms = events_ms(lambda: tb.best_paths_rows(*args, rows, lengths))
    S = logs.prev_slot.shape[1]
    chain = S * Tm + 9
    print(f"traceback rows [hclg200k.flood] B={B} K={K} T={T} S={S}, "
          f"pages of {P} frames: "
          f"{n} rows, lengths {int(lengths.min())}-{Tm} (median "
          f"{int(np.median(lengths))}): kernel == plain bit for bit; "
          f"{ms:.4f} ms a launch (device stream, the rows' page lists' "
          f"upload included), latency-chain bound {chain * l2 * 1e-3:.4f} ms at "
          f"the L2's {l2:.4f} us ({chain * l2 * 1e-3 / ms:.1%}), "
          f"{chain * hbm * 1e-3:.4f} ms at device memory's {hbm:.4f} us "
          f"({chain * hbm * 1e-3 / ms:.1%}); plain {pms:.1f} ms (wall)")
    tick = tuple(a[:F] for a in logs)
    lls = torch.randn((B, F, NUM_PDFS), generator=gen, device=dev)
    mine = rng.choice(B, adv, replace=False)
    offs = rng.integers(0, T - F, adv)
    valid = np.full(adv, F)
    valid[0] = F // 2
    want_pool = tuple(a.to("cpu", copy=True) for a in pool)
    packed = tb.store_frames(pool, tick, lls, pages, mine, offs, valid)
    want_packed = tb.store_frames_plain(
        want_pool, tuple(a.to("cpu", copy=True) for a in tick), lls.cpu(),
        pages, mine, offs, valid)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(pool, want_pool))
          and all(torch.equal(packed[i, :v].cpu(), want_packed[i, :v])
                  for i, v in enumerate(valid)),
          "store write [hclg200k.flood]: kernel == plain")
    ms = events_ms(lambda: tb.store_frames(pool, tick, lls, pages, mine,
                                           offs, valid))
    words = int(valid.sum()) * ((2 * S + 2) * K + NUM_PDFS)
    bms = 2 * 4 * words / HBM_BYTES_PER_S * 1e3
    print(f"store write [hclg200k.flood] {adv} rows x {F} frames into "
          f"pages of {P} frames, K={K} S={S} V={NUM_PDFS}: kernel == plain "
          f"bit for bit; {ms:.4f} ms a launch (device stream, the rows' "
          f"page lists' upload included), bound {bms:.4f} ms ({2 * 4 * words / 1e6:.1f} MB at "
          f"HBM bandwidth; {bms / ms:.1%})")
    del search, state, init_log, logs, args, pool, want_pool, ll


def phase_kernels(dev) -> dict:
    """Both search kernels at the main path's shapes (``GATHER_CASES``,
    ``FETCH_CASES``); returns the JSON numbers of each at its record shape
    (the gather f32 [32,2048]x[32,4096], the fetch [200001,32] B=16
    K=512 with every token live)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    floor = launch_floor_ms()
    print(f"launch floor: empty kernel {floor:.4f} ms device (graph replay)")
    out = {}
    err = 0.0
    for B, V, N, P, label in GATHER_CASES:
        for dtype in ((torch.float32, torch.int32) if P == 1
                      else (torch.float32,)):
            rec = gather_case(gen, dev, B, V, N, dtype, label, P, floor)
            err = max(err, rec["max_abs_err"])
            if (B, V, N, P) == (32, 2048, 4096, 1) and \
                    dtype == torch.float32:
                out["gather"] = rec
    out["gather"]["max_abs_err"] = err
    err = 0.0
    for S, L, shapes in FETCH_CASES:
        recs = fetch_cases(gen, dev, S, L, shapes, floor)
        err = max(err, *(r["max_abs_err"] for r in recs.values()))
        if (S, L) == (200_001, 32):
            out["fetch"] = recs[(BATCH, 512)]
    out["fetch"]["max_abs_err"] = err
    out["traceback"] = traceback_cases(dev, floor)
    return out


# ----------------------------------------------------------------------
# phase 3: the tools/perf row-gather kernels against their plain version
# ----------------------------------------------------------------------

def row_ms(fn) -> float:
    """Device ms a call of one of phase 3's row gathers (or its library
    call, or a copy) in the graph harness: ``ROW_SETS`` calls a loop, each
    meant to take the next of ``ROW_SETS`` inputs."""
    return time_ms(fn, calls=ROW_SETS, replays=5)[0]


def phase_rows(dev) -> dict:
    """The three TPU microbench kernels' counterparts — one CUDA kernel,
    ``ops/fetch.py:row_gather`` — against the plain ``table[idx]``, each
    timed in ``ROW_PAIRS`` alternating pairs with ``torch.index_select``
    over its live indices and beside the copy ceiling (a contiguous
    device-to-device copy of the bytes it reads and writes); each also
    drives its tool's chained calls (``bench_row_gather.chain``) once
    eagerly, the path whose launches are counted, and then runs through its
    tool's bench, which prints the tool's rows.
    Timed calls cycle through ``ROW_SETS`` index sets (the copy through as
    many slices of the table), so that a loop touches several times the
    50 MB L2 and the rows come from HBM, where the bytes bound holds."""
    from asr_decoder_tpu_torch.ops import fetch
    from asr_decoder_tpu_torch.tools.perf import bench_dma_variants as dv
    from asr_decoder_tpu_torch.tools.perf import bench_row_gather as rg
    from asr_decoder_tpu_torch.tools.perf._common import (paired_line,
                                                          paired_ms)
    gen = torch.Generator(device=dev).manual_seed(4)
    idxs = [torch.randint(0, ROW_S, (ROW_NIDX,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(ROW_SETS)]
    idx = idxs[0]
    it = iter(range(1 << 30))
    out = {k: dict(max_abs_err=0.0, launches=0) for k in
           ("make_dma_gather", "make_dma", "make_dma_dyn")}
    rows = []
    copies = {}
    for W in ROW_WIDTHS:
        table = torch.randint(-2**31, 2**31 - 1, (ROW_S, W), generator=gen,
                              device=dev, dtype=torch.int32)
        cases = [("make_dma", dv.make_dma(W), ROW_NIDX)]
        if W == 128:
            cases.insert(0, ("make_dma_gather", rg.make_dma_gather(),
                             ROW_NIDX))
            cases += [("make_dma_dyn", dv.make_dma_dyn(W, n), n)
                      for n in ROW_LIVE]
        for name, fn, n in cases:
            got = fn(table, idx)
            want = fetch.fetch_plain(table, idx[None])[0]
            torch.cuda.synchronize()
            check(torch.equal(got[:n], want[:n]),
                  f"{name} [{ROW_S},{W}] x {ROW_NIDX} rows < {n} bit-exact")
            err = (got[:n].double() - want[:n].double()).abs().max().item()
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            del got, want
            fetch.launches = 0
            rg.chain(fn, table, idx)()
            torch.cuda.synchronize()
            out[name]["launches"] += fetch.launches
            if (W, n) not in copies:
                # the copy ceiling: the live rows' bytes read and written
                # by one contiguous copy into a new tensor, as the kernel
                # writes one, from distinct slices of the table in turn
                srcs = [table[j * n:(j + 1) * n]
                        for j in range(min(ROW_SETS, ROW_S // n))]
                copies[W, n] = row_ms(
                    lambda: srcs[next(it) % len(srcs)].clone())
                cbms = bound_ms(8 * W * n)
                rows.append(f"rows    copy ceiling [{n},{W}]: device-to-"
                            f"device copy {copies[W, n]:.4f} ms, bound "
                            f"{cbms:.4f} ms ({cbms / copies[W, n]:.1%})")
                del srcs
            cms = copies[W, n]
            wms = time_ms(lambda: fn(table, idxs[next(it) % ROW_SETS]),
                          calls=ROW_SETS, replays=5)[1]
            pms, pwms = time_ms(lambda: rg.xla_row_gather(
                table, idxs[next(it) % ROW_SETS]), calls=ROW_SETS,
                replays=5)
            live_idxs = [i[:n] for i in idxs]
            paired = paired_ms(
                lambda: fn(table, idxs[next(it) % ROW_SETS]),
                lambda: torch.index_select(
                    table, 0, live_idxs[next(it) % ROW_SETS]), ROW_PAIRS,
                row_ms)
            print("rows    " + paired_line(f"{name} W={W} live {n}", paired))
            ms, lms = paired["kernel_ms"], paired["library_ms"]
            # the count, the live indices, each distinct row read once and
            # each live output row written once; the mean over the sets
            rows_read = np.mean([torch.unique(i).numel() for i in live_idxs])
            bms = bound_ms(4 + 4 * n + 4 * W * (rows_read + n))
            rows.append(f"rows    {name} [{ROW_S},{W}] x {ROW_NIDX}, live "
                        f"{n}: device kernel {ms:.4f} ms, bound "
                        f"{bms:.4f} ms ({bms / ms:.1%}), copy ceiling "
                        f"{cms:.4f} ms ({bms / cms:.1%}; the kernel at "
                        f"{cms / ms:.1%} of it), plain {pms:.4f} ms, "
                        f"library {lms:.4f} ms; per eager call kernel "
                        f"{wms:.4f} ms plain {pwms:.4f} ms")
            if (name, W, n) in (("make_dma_gather", 128, ROW_NIDX),
                                ("make_dma", ROW_WIDTHS[-1], ROW_NIDX),
                                ("make_dma_dyn", 128, ROW_LIVE[1])):
                out[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                 bound_ms=bms, bound_by="bytes")
                if name == "make_dma":
                    out[name]["copy_ms"] = cms
        del table
    for r in rows:
        print(r)
    for name, rec in out.items():
        check(rec["launches"] > 0,
              f"{name} kernel launched on its tool path ({rec['launches']})")
    # each tool's own bench (its launches, in CUDA-graph capture and replay
    # among them, are not counted)
    sizes = dict(rows=ROW_S, nidx=ROW_NIDX, device=dev)
    dv.bench_gather(rg.make_dma_gather(), rg.W, "tool rg: dma", **sizes)
    for W in ROW_WIDTHS:
        dv.bench_gather(dv.make_dma(W), W, f"tool dv: dma W={W}", **sizes)
    for n in ROW_LIVE:
        dv.bench_gather(dv.make_dma_dyn(128, n), 128,
                        f"tool dv: dma W=128 live={n}", **sizes)
    return out


# ----------------------------------------------------------------------
# phase 4: the full-size search, card against CPU
# ----------------------------------------------------------------------

def make_graph():
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    fst = random_hclg(np.random.default_rng(0), num_states=GRAPH_STATES,
                      num_ilabels=NUM_PDFS)
    # ilabel i scores AM row i-1 (the CTC map, ref nnet-nnet.h:226)
    i2p = np.concatenate([[0], np.arange(NUM_PDFS)]).astype(np.int32)
    return fst, i2p


def fixed_loglikes(frames: int, seed: int = 1) -> np.ndarray:
    """Log-softmax rows f32[BATCH, frames, NUM_PDFS] from a seed."""
    rng = np.random.default_rng(seed)
    sc = rng.standard_normal((BATCH, frames, NUM_PDFS)).astype(np.float32) * 2
    return sc - np.log(np.exp(sc).sum(-1, keepdims=True))


# host-issued CUDA calls that enqueue work: kernel and graph launches,
# copies and fills (the runtime and driver API names the profiler records)
ENQUEUE_CALLS = ("Launch", "Memcpy", "Memset")


def profile_cuda(fn) -> tuple[int, float, int]:
    """(CUDA kernels, memsets and copies included; their device ms; the
    host-issued CUDA calls that enqueue work) of one call of ``fn``, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from asr_decoder_tpu_torch.tools.perf.profile_production import \
        _device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    # the search's named ranges are spans with gaps: leave them out
    ops = [e for e in evs if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    calls = sum(e.count for e in evs if e.device_type == DeviceType.CPU
                and e.key.startswith("cu")
                and any(w in e.key for w in ENQUEUE_CALLS))
    return (sum(e.count for e in ops),
            sum(_device_us(e) for e in ops) / 1e3, calls)


def kernels_per_frame(search, ll: torch.Tensor) -> tuple[float, float]:
    """(CUDA kernels a frame, memsets and copies included; their device ms
    a frame), from ``torch.profiler`` over ``PROFILE_FRAMES`` frames of one
    advance."""
    state, _ = search.init_state(ll.shape[0])
    n, ms, _ = profile_cuda(
        lambda: search.advance(state, ll[:, :PROFILE_FRAMES]))
    return n / PROFILE_FRAMES, ms / PROFILE_FRAMES


def card_vs_cpu(dev, label: str, make, ll: np.ndarray, traceback) -> tuple:
    """``make(device)`` builds one search on the card and one on the CPU;
    both decode ``ll``: every leaf of the state and logs bit-identical
    (every search op is an exact int32 op, fp32 add/compare, gather or
    sort), and ``traceback(search, state, init_log, logs)`` equal.  Returns
    (card search, card run, card tracebacks, record: card kernel launches,
    ms/frame on each device, card kernels/frame)."""
    from asr_decoder_tpu_torch.ops import fetch, gather
    frames = ll.shape[1]
    runs, rec = [], {}
    for d in (dev, torch.device("cpu")):
        search = make(d)
        lld = torch.from_numpy(ll).to(d)
        search.decode(lld[:, :4])                       # warm-up
        gather.launches = fetch.launches = 0
        t0 = time.perf_counter()
        out = search.decode(lld)
        if d.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if d == dev:
            rec["launches"] = {"gather": gather.launches,
                               "fetch": fetch.launches}
            rec["kernels_per_frame"], rec["device_ms_per_frame"] = \
                kernels_per_frame(search, lld)
        rec["card_ms_per_frame" if d == dev else "cpu_ms_per_frame"] = \
            1e3 * dt / frames
        runs.append((search, out))
        print(f"{label} {d.type}: {BATCH}x{frames} frames in {dt:.3f} s = "
              f"{1e3 * dt / frames:.3f} ms/frame")
    (g, gout), (c, cout) = runs
    for go, co in zip(gout, cout):
        for gt, ct in zip(go, co):
            a, b = gt.cpu(), ct
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"{label} logs bit-identical card vs "
                                     f"CPU")
    gres = traceback(g, *gout)
    check(gres == traceback(c, *cout),
          f"{label} words/arc ids/costs card vs CPU")
    check(all(np.isfinite(r["cost"]) and r["ilabels"] for r in gres),
          f"{label}: every utterance has a finite best path")
    return g, gout, gres, rec


def gathers_per_frame(search, dev, frames: int = 8) -> float:
    """Gather launches a frame of ``search.advance`` on the card (decode
    adds the initial ε stage's)."""
    from asr_decoder_tpu_torch.ops import gather
    state, _ = search.init_state(BATCH)
    ll = torch.from_numpy(fixed_loglikes(frames, seed=2)).to(dev)
    gather.launches = 0
    search.advance(state, ll)
    torch.cuda.synchronize()
    return gather.launches / frames


@contextmanager
def eager_graphs():
    """The eager side of the graph-vs-eager A/B: every ``GraphRunner``
    call runs its body on its buffers (the CPU path's code) instead of
    replaying its graph.  Only this script does this, and only inside the
    block."""
    from asr_decoder_tpu_torch.utils.cuda_graphs import GraphRunner
    run = GraphRunner._run
    GraphRunner._run = GraphRunner._eager
    try:
        yield
    finally:
        GraphRunner._run = run


def graphs_vs_eager(label: str, run, per: int, unit: str, head=None,
                    head_per: int = 1) -> dict:
    """``run()`` (returning a flat list of tensors) through captured graphs
    and eagerly (``eager_graphs``) on the card: every tensor bit-identical,
    the search kernels' launch counts equal; then ``GRAPH_PAIRS``
    alternating pairs of wall ms per ``unit`` (``per`` of them a run), and
    the host-issued CUDA calls per ``unit`` of each: the graph's over
    ``run``, the eager side's over ``head()`` (``head_per`` units; a
    profile of every eager launch of a long run costs minutes).  The
    card's busy share of each = the graph run's device ms (the same
    kernels either way) over its wall ms.  Prints one "graphs" line;
    returns its numbers."""
    from asr_decoder_tpu_torch.ops import fetch, gather
    t_line = time.perf_counter()

    def counted_run(eager: bool):
        gather.launches = fetch.launches = 0
        with eager_graphs() if eager else nullcontext():
            out = [t.cpu() for t in run()]
        return out, (gather.launches, fetch.launches)

    (g, gn), (e, en) = counted_run(False), counted_run(True)
    for a, b in zip(g, e):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"graphs {label}: graph == eager, bit for "
                                 f"bit")
    check(gn == en, f"graphs {label}: launches graph {gn} == eager {en}")
    ms = {"graph": [], "eager": []}
    for i in range(GRAPH_PAIRS):
        for name in ("graph", "eager")[::1 if i % 2 == 0 else -1]:
            with eager_graphs() if name == "eager" else nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / per)
    _, dev_ms, calls = profile_cuda(run)
    with eager_graphs():
        _, eager_dev_ms, eager_calls = profile_cuda(head or run)
    rec = {"launches": {"gather": gn[0], "fetch": gn[1]},
           "device_ms": dev_ms / per}
    for name, c in (("graph", calls / per),
                    ("eager", eager_calls / (head_per if head else per))):
        med = float(np.median(ms[name]))
        rec[name] = dict(ms=med, ms_range=(min(ms[name]), max(ms[name])),
                         calls=c, busy=rec["device_ms"] / med)
    gr, ea = rec["graph"], rec["eager"]
    wins = sum(a < b for a, b in zip(ms["graph"], ms["eager"]))
    print(f"graphs {label}: graph == eager bit for bit, launches equal "
          f"(gather {gn[0]}, fetch {gn[1]}); ms/{unit} graph "
          f"{gr['ms']:.3f} [{gr['ms_range'][0]:.3f}, "
          f"{gr['ms_range'][1]:.3f}] vs eager {ea['ms']:.3f} "
          f"[{ea['ms_range'][0]:.3f}, {ea['ms_range'][1]:.3f}] in "
          f"{GRAPH_PAIRS} alternating pairs (graph faster in {wins}); host "
          f"CUDA calls/{unit} {gr['calls']:.2f} vs {ea['calls']:.1f}"
          f"{f' (eager over {head_per} {unit}s)' if head else ''}; device "
          f"ms/{unit} {rec['device_ms']:.3f} (eager over the same {unit}s "
          f"{eager_dev_ms / (head_per if head else per):.3f}); card busy "
          f"{100 * gr['busy']:.1f}% vs {100 * ea['busy']:.1f}%; "
          f"{time.perf_counter() - t_line:.1f} s")
    return rec


def graph_search(search, dev, label: str) -> dict:
    """``graphs_vs_eager`` of ``search.advance`` over ``GRAPH_FRAMES``
    frames of fixed loglikes with a dead frame and a partly masked row:
    the new beam, logs and snapshots."""
    B = BATCH
    ll = torch.from_numpy(fixed_loglikes(GRAPH_FRAMES, seed=4)).to(dev)
    mask = np.ones((B, GRAPH_FRAMES), bool)
    mask[:, GRAPH_DEAD] = False
    mask[GRAPH_ROW, GRAPH_ROW_LEN:] = False
    state, _ = search.init_state(B)

    def run(frames: int = GRAPH_FRAMES):
        new, logs = search.advance(state, ll[:, :frames], mask[:, :frames])
        return [*new, *logs]
    return graphs_vs_eager(label, run, GRAPH_FRAMES, "frame",
                           head=lambda: run(PROFILE_FRAMES),
                           head_per=PROFILE_FRAMES)


def phase_search(dev, fst, i2p, frames: int = FRAMES, **engine) -> dict:
    """One search config (``SEARCH`` with ``engine`` over it) on the card
    and on the CPU, bit-identical; returns the kernel launches of the card
    run and its ms/frame on both devices."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    dfst = DeviceFst.build(fst, arc_lanes=ARC_LANES)
    cfg = DecoderConfig(**{**SEARCH, **engine})
    g, gout, gres, rec = card_vs_cpu(
        dev, "search", lambda d: TorchBeamSearch(dfst, i2p, cfg, device=d),
        fixed_loglikes(frames), lambda s, *out: s.traceback(*out, fst))
    live = (gout[0].tok_state >= 0).sum(1).float().mean().item()
    rec["gather_per_frame"] = gathers_per_frame(g, dev)
    rec["graphs"] = graph_search(
        g, dev, "v3" if g.lanes else f"v2 {g.mode}")
    what = (f"v3, {g.lanes}-lane records" if g.lanes
            else f"v2 {g.mode}, {g.num_stages} stages")
    print(f"search card == CPU ({g.relax_impl}, {g.mode}): {what} over "
          f"{dfst.num_states} states; logs bit-identical, words and costs "
          f"equal for {len(gres)} utterances (mean live tokens at the end "
          f"{live:.1f}, words in utt 0: {len(gres[0]['words'])}); card "
          f"kernel launches {rec['launches']} "
          f"({rec['gather_per_frame']:g} gather launches a frame), "
          f"{rec['kernels_per_frame']:.0f} kernels/frame "
          f"({rec['device_ms_per_frame']:.3f} device ms/frame)")
    return rec


# ----------------------------------------------------------------------
# phase 5: the full-width AM, card against CPU
# ----------------------------------------------------------------------

def phase_am(dev, nnet) -> None:
    from asr_decoder_tpu_torch.models.nnet import am_forward
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, 3 * FRAMES, FEAT_DIM)).astype(np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        net = nnet.to(d)
        with torch.inference_mode():
            am_forward(net.layers, x[:, :6].to(d), net.init_state(BATCH, d),
                       skip=SKIP)                              # warm-up
            t0 = time.perf_counter()
            y, _ = am_forward(net.layers, x.to(d), net.init_state(BATCH, d),
                              skip=SKIP)
            y = y.cpu()
        outs.append((y, time.perf_counter() - t0))
    (yg, tg), (yc, tc) = outs
    check(yg.shape == (BATCH, FRAMES, NUM_PDFS), f"AM shape {yg.shape}")
    check(bool(torch.isfinite(yg).all()), "AM output finite")
    err = (yg - yc).abs().max().item()
    check(err <= AM_ATOL, f"AM card vs CPU max abs err {err} <= {AM_ATOL}")
    print(f"am: flagship [{BATCH},{3 * FRAMES},{FEAT_DIM}] -> "
          f"{tuple(yg.shape)}: card {tg:.3f} s, CPU {tc:.3f} s, max abs "
          f"err {err:.3e} (tolerance {AM_ATOL})")
    graph_am(dev, nnet.to(dev))


def graph_am(dev, nnet) -> dict:
    """``graphs_vs_eager`` of the AM chunk as ``OnlineDecoderInfo.score``
    runs it (``GraphedAm`` over the layers after the splice, which the
    feature buffer applies; ``AmConfig(skip=SKIP)``'s flags): one
    [BATCH, AM_CHUNK, 3·FEAT_DIM] chunk from a mid-stream carry, the
    log-likelihoods and the new carries."""
    from asr_decoder_tpu_torch.models.nnet import AmConfig, GraphedAm
    ac = AmConfig(skip=SKIP)
    flags = dict(do_softmax=ac.do_softmax, do_log=ac.do_log,
                 sub_prior=ac.sub_prior, block_pdf_pdfid=ac.block_pdf_pdfid,
                 block_scale=ac.block_scale, skip_block=ac.skip_block,
                 skip=0, skip_copy=False)
    layers = list(nnet.layers)[1:]
    am = GraphedAm(layers)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, AM_CHUNK, layers[0].input_dim)).astype(np.float32)).to(dev)
    state = [{k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                  .astype(np.float32) * 0.1).to(dev)
              for k, v in st.items()}
             for st in (l.init_state(BATCH, dev) for l in layers)]

    @torch.inference_mode()
    def run():
        y, new = am(x, state, **flags)
        return [y, *(v for st in new for v in st.values())]
    return graphs_vs_eager(f"am [{BATCH},{AM_CHUNK},{layers[0].input_dim}]",
                           run, 1, "chunk")


# ----------------------------------------------------------------------
# phase 6: serve through the port's server
# ----------------------------------------------------------------------

def serve_waves(utts: int, seconds: float) -> list[np.ndarray]:
    """The served runs' int16-valued waves, from seed 3."""
    rng = np.random.default_rng(3)
    return [(rng.standard_normal(int(16000 * seconds)) * 4000)
            .astype(np.int16) for _ in range(utts)]


def serve_check(info, utts: int, label: str,
                seconds: float = UTT_SECONDS) -> dict:
    """Serve ``utts`` concurrent utterances of ``seconds`` through
    ``AsrServer`` over
    ``info``; every final reply must equal an in-process
    ``BatchedStreamingDecoder`` on the same waves and chunks.  Returns the
    kernel launches of the serve run, that arena, its channels and the
    waves."""
    from asr_decoder_tpu_torch.serving.client import AsyncAsrClient
    from asr_decoder_tpu_torch.serving.protocol import EndFlag
    from asr_decoder_tpu_torch.ops import fetch, gather, traceback
    from asr_decoder_tpu_torch.serving.batcher import BatchedStreamingDecoder
    from asr_decoder_tpu_torch.serving.server import AsrServer, SocketConfig
    n = int(16000 * seconds)
    waves = serve_waves(utts, seconds)

    async def serve():
        server = AsrServer(info, SocketConfig(port=0, num_channels=utts))
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    return await c.decode_utterance(w, chunk_samples=CHUNK)
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w) for w in waves)), server
        finally:
            await server.stop()

    gather.launches = fetch.launches = traceback.launches = 0
    traceback.row_launches = traceback.store_launches = 0
    t0 = time.perf_counter()
    replies, server = asyncio.run(serve())
    wall = time.perf_counter() - t0
    launches = {"gather": gather.launches, "fetch": fetch.launches}
    # the v3 search keeps its logs on the card and walks each round's
    # paths there; the other searches walk host logs
    stored = server._batcher._stored
    check(traceback.launches == 0 and (traceback.row_launches > 0) == stored
          and (traceback.store_launches > 0) == stored,
          f"{label}: the served path writes and walks "
          f"{'its card log store' if stored else 'its host logs'} "
          f"({traceback.store_launches} store write launches, "
          f"{traceback.row_launches} store walk launches, "
          f"{traceback.launches} offline traceback launches)")

    # reference: the same waves, chunks and arena width, in process
    eng = BatchedStreamingDecoder(info, utts)
    cids = [eng.acquire() for _ in waves]
    for off in range(0, n, CHUNK):
        for cid, w in zip(cids, waves):
            eng.push(cid, w[off:off + CHUNK].astype(np.float32),
                     eos=off + CHUNK >= n)
    eng.drain()
    want = [eng.get_best_path(c)["words"] for c in cids]
    answered = sum(r.end_flag == EndFlag.END and bool(r.results)
                   for r in replies)
    check(answered == utts, f"{label}: {answered} of {utts} requests "
                            f"answered")
    same = sum(r.results[0].words == w for r, w in zip(replies, want))
    check(same == utts, f"{label}: {same} of {utts} served results equal "
                        f"the in-process batcher")
    check(launches["gather"] > 0,
          f"{label}: gather kernel launched during the serve run")
    audio = utts * seconds
    print(f"{label}: {utts} concurrent {seconds:g}-s utterances = "
          f"{audio:g} audio-s in {wall:.3f} s wall ({audio / wall:.2f} "
          f"audio-s/s incl. first-use warm-up), {server.dispatches} "
          f"dispatches, {server.chunks_decoded} channel-chunks; "
          f"{answered}/{utts} answered, {same}/{utts} equal the batcher; "
          f"warn set on {sum(r.warn for r in replies)}; kernel launches "
          f"{launches}; words in utt 0: {len(want[0])}")
    return launches, eng, cids, waves


def serve_results(info, eng, cids, waves) -> None:
    """The arena's per-channel results on the card, on the thread that
    stepped it: every channel's word alignment (its words those of the
    best path) and lattice; then ``SESSION_UTTS`` of the waves decoded in
    lone card ``OnlineDecoderSession``s in the same chunks, each channel's
    alignment equal to its session's and its lattice's 3-best texts equal
    to the session's."""
    from asr_decoder_tpu_torch.serving.session import (OnlineDecoderSession,
                                                       nbest_from_lattice)
    t_all = time.perf_counter()
    aligns, lats, ms = [], [], []
    for cid in cids:
        align = eng.get_word_alignment(cid)
        check([w for w, _, _ in align]
              == eng.get_best_path_txt(cid).split(),
              f"serve results: channel {cid}'s alignment has its best "
              f"path's words")
        t0 = time.perf_counter()
        lat = eng.get_lattice(cid)
        ms.append(1e3 * (time.perf_counter() - t0))
        check(lat is not None and lat.num_states > 0,
              f"serve results: channel {cid} has a lattice")
        aligns.append(align)
        lats.append(lat)
    n = len(waves[0])
    same_align = same_nbest = 0
    for i in range(SESSION_UTTS):
        s = OnlineDecoderSession(info)
        for off in range(0, n, CHUNK):
            s.process_data(waves[i][off:off + CHUNK].astype(np.float32),
                           eos=off + CHUNK >= n)
        frames = eng.snapshot(cids[i]).frames_decoded
        check(s.num_frames_decoded == frames,
              f"serve results: session {i} decoded {s.num_frames_decoded} "
              f"frames, its channel {frames}")
        same_align += aligns[i] == s.get_word_alignment()
        same_nbest += ([r["text"] for r in nbest_from_lattice(info, lats[i],
                                                               3)]
                       == s.get_nbest_txt(3))
    check(same_align == SESSION_UTTS,
          f"serve results: {same_align} of {SESSION_UTTS} alignments equal "
          f"their card session's")
    check(same_nbest == SESSION_UTTS,
          f"serve results: {same_nbest} of {SESSION_UTTS} lattice 3-best "
          f"texts equal their card session's")
    print(f"serve results: {len(cids)}/{len(cids)} channels aligned "
          f"({sum(map(len, aligns))} words), {same_align}/{SESSION_UTTS} "
          f"alignments equal their card session, {same_nbest}/"
          f"{SESSION_UTTS} lattice n-best equal; get_lattice ms per channel "
          f"{np.median(ms):.1f} [{min(ms):.1f}, {max(ms):.1f}] "
          f"({int(np.median([l.num_states for l in lats]))} states median); "
          f"{time.perf_counter() - t_all:.1f} s in all")


def make_words(num_words: int):
    """The symbol table <eps> = 0, then w<i> = i."""
    from asr_decoder_tpu_torch.fst.symbol import SymbolTable
    words = SymbolTable()
    words.add("<eps>", 0)
    for w in range(1, num_words + 1):
        words.add(f"w{w}", w)
    return words


def cli_flags(dev) -> list[str]:
    """The ``cli.decode`` / ``cli.serve`` flags that reproduce phase 6's
    info: ``SEARCH``, the CTC blank shift, the fbank width and the AM's
    frame skip, on ``dev``."""
    return ([f"--{k.replace('_', '-')}={v}" for k, v in SEARCH.items()]
            + ["--ctc-blank-shift=true", f"--fbank.num-bins={FEAT_DIM}",
               f"--am.skip={SKIP}", f"--device={dev}"])


def write_wav(path: Path, samples: np.ndarray) -> None:
    import wave
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(samples, np.int16).tobytes())


def cli_decode(info, tmp: Path, paths: list[str], waves) -> tuple:
    """``cli.decode.main`` over ``waves`` written as 16-bit wav files, with
    a wav list and a reference transcript of each wave's words in a lone
    card ``OnlineDecoderSession`` over the whole wave; every utterance's
    words must equal its session's (so %WER 0.00), and some words must be
    decoded.  Both kernels are then held bit-exactly to their plain
    versions at every shape the CLI's run launched them at.  Returns the
    CLI's words by utterance and ``counted``'s record of the CLI's run,
    with the kernels' max abs err."""
    import contextlib
    import io
    from asr_decoder_tpu_torch.cli import decode
    from asr_decoder_tpu_torch.serving.session import OnlineDecoderSession
    want = {}
    for i, w in enumerate(waves):
        write_wav(tmp / f"u{i}.wav", w)
        s = OnlineDecoderSession(info)
        s.process_data(w.astype(np.float32), eos=True)
        want[f"u{i}"] = s.get_best_path_txt()
    (tmp / "wav.list").write_text("".join(f"{u} {tmp / u}.wav\n"
                                          for u in want))
    (tmp / "ref.txt").write_text("".join(f"{u} {t}\n"
                                         for u, t in want.items()))
    check(sum(len(t.split()) for t in want.values()) > 0,
          "cli decode: the card sessions decoded some words")
    out, err = io.StringIO(), io.StringIO()

    def run():
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            return decode.main(cli_flags(info.device) + [
                f"--ref-text={tmp / 'ref.txt'}", *paths,
                str(tmp / "wav.list")])
    t0 = time.perf_counter()
    rc, n = counted(run, "cli decode")
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli decode: rc {rc}; stderr {err.getvalue()[-2000:]}")
    got = dict((ln.split(" ", 1) + [""])[:2]
               for ln in out.getvalue().splitlines())
    same = sum(got.get(u) == t for u, t in want.items())
    check(same == len(want) == len(got),
          f"cli decode: {same} of {len(want)} utterances equal their card "
          f"session ({len(got)} printed)")
    lines = err.getvalue().splitlines()
    rtf = [ln for ln in lines if "real-time factor" in ln]
    wer = [ln for ln in lines if ln.startswith("%WER")]
    check(len(rtf) == 1 and len(wer) == 1
          and wer[0].startswith("%WER 0.00 "),
          f"cli decode: one RTF line and %WER 0.00 ({rtf}, {wer})")
    # the CLI counts subsampled frames at 100 a second, as the JAX CLI
    # and the reference do: at skip 2 it reads ~3x the wall RTF
    print(f"cli decode: {same}/{len(want)} equal their card session; "
          f"%WER 0.00; RTF {rtf[0].rsplit(' ', 1)[1]} (the CLI's own line); "
          f"{wall:.1f} s; kernel launches gather {n['gather']} fetch "
          f"{n['fetch']}")
    n["max_abs_err"] = hold_launched_shapes(info.device, n, "cli decode")
    return got, n


def cli_serve(dev, paths: list[str], waves, want: dict) -> None:
    """``python -m asr_decoder_tpu_torch.cli.serve`` on the card in a
    subprocess, over phase 6's files and flags on a port the system picks
    (``--port=0``: the server's "listening on" line names it); once it
    listens (within ``CLI_START_S``), ``waves`` are streamed to it at once
    through ``serving/client.py`` in ``CHUNK`` pushes, and their final
    texts must equal the decode CLI's (``want``: u<i> → words).  Then the
    server is terminated and waited for."""
    import re
    import threading
    from asr_decoder_tpu_torch.serving.client import AsyncAsrClient
    from asr_decoder_tpu_torch.serving.protocol import EndFlag
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "asr_decoder_tpu_torch.cli.serve",
         "--port=0", *cli_flags(dev), *paths],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    log, up, bound = [], threading.Event(), []

    def read():                 # drain stderr; note the port it listens on
        for line in proc.stderr:
            log.append(line.rstrip())
            m = re.search(r"listening on [\d.]+:(\d+)\b", line)
            if m and not up.is_set():
                bound.append(int(m.group(1)))
                up.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while not up.wait(0.2):
            check(proc.poll() is None and time.perf_counter() - t0
                  < CLI_START_S, f"cli serve: not listening (exit "
                  f"{proc.poll()}, {time.perf_counter() - t0:.0f} s); "
                  f"stderr {log[-20:]}")
        start_s = time.perf_counter() - t0
        port = bound[0]

        async def one(w):
            c = AsyncAsrClient("127.0.0.1", port)
            await c.connect()
            try:
                t = time.perf_counter()
                first = None
                for off in range(0, len(w), CHUNK):
                    r = await c.send_chunk(w[off:off + CHUNK],
                                           end=off + CHUNK >= len(w))
                    first = first or 1e3 * (time.perf_counter() - t)
                return r, first
            finally:
                await c.close()

        async def both():
            return await asyncio.gather(*(one(w) for w in waves))
        replies = asyncio.run(asyncio.wait_for(both(), CLI_REPLY_S))
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        reader.join(timeout=10)
    check(rc in (0, -15), f"cli serve: exit {rc} on SIGTERM")
    texts = [r.results[0].text
             if r.end_flag == EndFlag.END and r.results else None
             for r, _ in replies]
    same = sum(t == want[f"u{i}"] for i, t in enumerate(texts))
    check(same == len(waves), f"cli serve: {same} of {len(waves)} final "
                              f"texts equal the decode CLI's")
    print(f"cli serve: {same}/{len(waves)} equal the decode CLI; first "
          f"reply after {min(f for _, f in replies):.1f} ms (from the "
          f"first push of {len(waves)} streams at once); listening "
          f"{start_s:.1f} s after the process started")


def phase_serve(dev, nnet, fst) -> dict:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.cli._model import build_info
    from asr_decoder_tpu_torch.frontend.fbank import FbankConfig
    from asr_decoder_tpu_torch.models.nnet import AmConfig
    from asr_decoder_tpu_torch.serving.session import OnlineDecoderConfig

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / n) for n in ("am.nnet", "graph.fst",
                                              "words.txt")]
        nnet.write_binary(paths[0])
        fst.write_binary(paths[1])
        make_words(int(fst.arc_olabel.max())).write_text(paths[2])
        info = build_info(
            *paths, DecoderConfig(**SEARCH),
            OnlineDecoderConfig(ctc_blank_shift=True),
            FbankConfig(num_bins=FEAT_DIM), AmConfig(skip=SKIP),
            {"trans-model": ""}, device=dev)
        launches, eng, cids, waves = serve_check(info, UTTS, "serve")
        check(launches["fetch"] > 0, "fetch kernel launched during the "
                                     "serve run")
        serve_results(info, eng, cids, waves)
        words, n = cli_decode(info, Path(tmp), paths, waves[:CLI_UTTS])
        cli_serve(dev, paths, waves[:CLI_SERVE_UTTS], words)
    return ({k: launches[k] + n[k] for k in ("gather", "fetch")}
            | {"max_abs_err": n["max_abs_err"]}), info


# ----------------------------------------------------------------------
# phase 7: the clg and biglm-hclg graph types
# ----------------------------------------------------------------------

def make_hmms(rng, n: int):
    """[None, hmm_1..hmm_n]: three-state linear-chain HMMs (a self-loop and
    a forward arc a state, an ε exit from the last), ilabels in
    [1, NUM_PDFS] (scored through the CTC map of ``make_graph``)."""
    from asr_decoder_tpu_torch.fst.fst import StdFst
    src = np.array([0, 0, 1, 1, 2, 2])
    dst = np.array([0, 1, 1, 2, 2, 2], np.int32)
    hmms = [None]
    for _ in range(n):
        il = rng.integers(1, NUM_PDFS + 1, 6).astype(np.int32)
        il[5] = 0                                   # exit ε
        hmms.append(StdFst.from_arcs(
            3, 0, 2, src, il, np.zeros(6, np.int32),
            rng.random(6).astype(np.float32), dst))
    return hmms


def make_difflm(device):
    """The BigLM difference G2 − G1 over two synthetic ARPA LMs whose word
    w<i> is id i — the graph's olabel i; <s>, </s> get ids above it."""
    from asr_decoder_tpu_torch.lm.arpa import parse_arpa
    from asr_decoder_tpu_torch.lm.synth_arpa import synth_arpa_text
    from asr_decoder_tpu_torch.lm.device_lm import DeviceDiffLm
    word2id = {f"w{i}": i for i in range(1, LM_VOCAB + 1)}
    word2id.update({"<s>": LM_VOCAB + 1, "</s>": LM_VOCAB + 2})
    fsas = [parse_arpa(synth_arpa_text(**kw), word2id=word2id)
            for kw in (LM1, LM2)]
    return fsas, lambda d: DeviceDiffLm.build(*fsas, device=d)


def compaction_gathers(lm, N: int, lm_lanes: int) -> int:
    """Gather launches of one BigLM LM application with compaction on
    (``lm_lanes`` < N word-candidate lanes) at B = BATCH."""
    from asr_decoder_tpu_torch.ops import gather
    from asr_decoder_tpu_torch.ops.beamsearch_biglm import _apply_lm
    dev = lm.lm1.table.device
    gen = torch.Generator(device=dev).manual_seed(9)

    def ints(hi):
        return torch.randint(0, hi, (BATCH, N), generator=gen, device=dev,
                             dtype=torch.int32)
    ol = torch.where(ints(10) == 0, ints(LM_VOCAB) + 1, 0)
    args = (ol, ints(lm.lm1.fsa.num_states), ints(lm.lm2.fsa.num_states),
            ints(GRAPH_STATES), torch.rand((BATCH, N), generator=gen,
                                           device=dev), ints(512), ints(N))
    gather.launches = 0
    _apply_lm(lm, *args, lm_lanes=lm_lanes)
    torch.cuda.synchronize()
    print(f"biglm compaction: {gather.launches} gather launch for "
          f"{len(args)} operands, [{BATCH},{N}] -> {lm_lanes} LM lanes")
    return gather.launches


def phase_graph_types(dev, nnet, fst, i2p) -> dict:
    """Each graph type: the gather kernel at its table shapes, the search
    card against CPU, then a served run.  Returns the gather launches of
    the card searches and serve runs, and the gather's worst error."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.fst.clg import write_hmm_bundle
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    from asr_decoder_tpu_torch.cli._model import build_info
    from asr_decoder_tpu_torch.frontend.fbank import FbankConfig
    from asr_decoder_tpu_torch.models.nnet import AmConfig
    from asr_decoder_tpu_torch.ops.beamsearch_biglm import \
        TorchBigLmBeamSearch
    from asr_decoder_tpu_torch.ops.beamsearch_clg import TorchClgBeamSearch
    from asr_decoder_tpu_torch.serving.session import (OnlineDecoderConfig,
                                                       OnlineDecoderInfo)
    gen = torch.Generator(device=dev).manual_seed(6)
    cfg = DecoderConfig(**SEARCH)
    K = cfg.beam_width
    ll = fixed_loglikes(GT_FRAMES, seed=7)
    am_cfg = (FbankConfig(num_bins=FEAT_DIM), AmConfig(skip=SKIP))
    total = {"gather": 0, "max_abs_err": 0.0}

    floor = launch_floor_ms()

    def gather_rows(cases):
        for V, N, P, what in cases:
            for dtype in ((torch.float32, torch.int32) if P == 1
                          else (torch.float32,)):
                rec = gather_case(gen, dev, BATCH, V, N, dtype, f" ({what})",
                                  P, floor)
                total["max_abs_err"] = max(total["max_abs_err"],
                                           rec["max_abs_err"])

    # --- clg: the CLI loader with --hmmfst-file -------------------------
    t0 = time.perf_counter()
    clg = random_hclg(np.random.default_rng(5), num_states=GRAPH_STATES,
                      num_ilabels=CLG_HMMS)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {n: str(Path(tmp) / n) for n in ("am", "clg", "hmm",
                                                 "words")}
        nnet.write_binary(paths["am"])
        clg.write_binary(paths["clg"])
        write_hmm_bundle(paths["hmm"], make_hmms(np.random.default_rng(8),
                                                 CLG_HMMS))
        make_words(int(clg.arc_olabel.max())).write_text(paths["words"])
        info = build_info(
            paths["am"], paths["clg"], paths["words"], cfg,
            OnlineDecoderConfig(graph_type="clg", ctc_blank_shift=True),
            *am_cfg, {"trans-model": "", "hmmfst-file": paths["hmm"]},
            device=dev)
    g = info.search.g
    Ae = info.search._cfg["Ae"]
    # the CPU search reuses the card's ε depth (ClgFst.eps_depth walks the
    # whole graph in Python)
    cpu_cfg = DecoderConfig(**SEARCH, eps_iters=info.search._cfg["E"])
    print(f"clg: {g.clg.num_states} CLG states, {g.clg.num_arcs} arcs, "
          f"{CLG_HMMS} HMMs, {info.search.num_stages - 1} ε sweeps, Ae = "
          f"{Ae}; built in {time.perf_counter() - t0:.1f} s")
    gather_rows([(K * Ae + 2 * K, K, 2, "clg ε table")])
    _, gout, gres, rec = card_vs_cpu(
        dev, "clg search",
        lambda d: info.search if d == dev else TorchClgBeamSearch(
            g, i2p, cpu_cfg, device=d),
        ll, lambda s, *out: s.traceback(*out))
    check(rec["launches"]["gather"] > 0, "gather kernel launched by clg")
    rec["graphs"] = graph_search(info.search, dev, "clg")
    print(f"graph types: clg card == CPU: logs bit-identical, words and "
          f"costs equal for {len(gres)} utterances (reached final: "
          f"{sum(r['reached_final'] for r in gres)}, words in utt 0: "
          f"{len(gres[0]['words'])}); {rec['card_ms_per_frame']:.3f} vs "
          f"{rec['cpu_ms_per_frame']:.3f} ms/frame card vs CPU, "
          f"{rec['kernels_per_frame']:.0f} kernels/frame "
          f"({rec['device_ms_per_frame']:.3f} device ms/frame); card kernel "
          f"launches {rec['launches']}")
    total["gather"] += rec["launches"]["gather"]
    total["clg"] = rec
    total["gather"] += serve_check(info, GT_UTTS, "serve clg",
                                   GT_SECONDS)[0]["gather"]
    del info

    # --- biglm-hclg: an info made in process with its DeviceDiffLm ------
    t0 = time.perf_counter()
    fsas, difflm = make_difflm(dev)
    dfst = DeviceFst.build(fst, arc_lanes=ARC_LANES)
    lm = difflm(dev)
    info = OnlineDecoderInfo(
        nnet, fst, make_words(int(fst.arc_olabel.max())), i2p, cfg,
        OnlineDecoderConfig(graph_type="biglm-hclg", ctc_blank_shift=True),
        *am_cfg, difflm=lm, device=dev)
    s = info.search
    A, L = s._cfg["A"], int(s.graph.eps_rec.shape[1]) // 4
    print(f"biglm: G1 {fsas[0].num_states} states / {fsas[0].num_arcs} "
          f"arcs (levels {lm.lm1.levels}, max probes {lm.lm1.max_probes}), "
          f"G2 {fsas[1].num_states} / {fsas[1].num_arcs} (levels "
          f"{lm.lm2.levels}, max probes {lm.lm2.max_probes}); lm_lanes "
          f"{cfg.lm_lanes} of K·A = {K * A} (safe bound "
          f"{s.lm_lanes_bound}); {s.num_stages - 1} ε sweeps; built in "
          f"{time.perf_counter() - t0:.1f} s")
    gather_rows([(K * A, K * A, 7, "biglm compaction"),
                 (K * L + K, K, 2, "biglm ε table")])
    check(compaction_gathers(lm, K * A, cfg.lm_lanes) == 1,
          "the BigLM compaction is one gather launch")
    _, gout, gres, rec = card_vs_cpu(
        dev, "biglm search",
        lambda d: s if d == dev else TorchBigLmBeamSearch(
            dfst, i2p, difflm(d), cfg, device=d),
        ll, lambda s_, *out: s_.traceback(*out, fst))
    check(rec["launches"]["gather"] > 0, "gather kernel launched by biglm")
    rec["graphs"] = graph_search(s, dev, "biglm-hclg")
    ovf = gout[2].overflow
    print(f"graph types: biglm card == CPU: logs, LM lanes and overflow "
          f"flags bit-identical, words and costs equal for {len(gres)} "
          f"utterances (reached final: "
          f"{sum(r['reached_final'] for r in gres)}, words in utt 0: "
          f"{len(gres[0]['words'])}); {rec['card_ms_per_frame']:.3f} vs "
          f"{rec['cpu_ms_per_frame']:.3f} ms/frame card vs CPU, "
          f"{rec['kernels_per_frame']:.0f} kernels/frame "
          f"({rec['device_ms_per_frame']:.3f} device ms/frame); overflow in "
          f"{int(ovf.sum())} of {ovf.numel()} utterance-frames, "
          f"{sum(r['overflowed'] for r in gres)} utterances overflowed; "
          f"card kernel launches {rec['launches']}")
    total["gather"] += rec["launches"]["gather"]
    total["biglm"] = rec
    total["gather"] += serve_check(info, GT_UTTS, "serve biglm",
                                   GT_SECONDS)[0]["gather"]
    total["biglm_search"] = s
    return total



# ----------------------------------------------------------------------
# phase 8: the VAD-driven serve path
# ----------------------------------------------------------------------

def vad_streams(seed: int = 8):
    """VAD_STREAMS int16-valued waves — a voiced, gliding harmonic tone in
    noise (RMS ~2,500), SIL_S of noise at RMS 20 (below energy_threshold1,
    327.68), the tone again — with each wave's push boundaries and the
    sample where its silence starts."""
    rng = np.random.default_rng(seed)

    def speech(secs, f0):
        t = np.arange(int(16000 * secs)) / 16000
        ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.3 * np.sin(2 * np.pi * 0.7
                                                          * t))) / 16000
        return (3000 * np.sin(ph) + 1500 * np.sin(2 * ph)
                + 800 * np.sin(3 * ph) + 400 * rng.standard_normal(len(t)))
    out = []
    for i in range(VAD_STREAMS):
        a = speech(1.3 + 0.05 * i, 100 + 10 * i)
        w = np.concatenate([a, 20 * rng.standard_normal(int(16000 * SIL_S)),
                            speech(1.2 + 0.05 * i, 180 - 8 * i)])
        w = np.clip(np.round(w), -32768, 32767).astype(np.int16)
        cuts, lo = [], 0
        while lo < len(w):
            hi = min(len(w), lo + int(rng.integers(PUSH_SAMPLES[0],
                                                   PUSH_SAMPLES[1] + 1)))
            cuts.append((lo, hi))
            lo = hi
        out.append((w, cuts, len(a)))
    return out


def run_segments(session, wave, cuts) -> tuple[list, list]:
    """Push ``wave`` in ``cuts`` through an ``OnlineDecoderSession``,
    restarting its search at each endpoint as the server does: (the
    endpoint flag of every push, (words, frames) of every segment)."""
    flags, segs = [], []
    for lo, hi in cuts:
        eos = hi >= len(wave)
        session.process_data(wave[lo:hi].astype(np.float32), eos=eos)
        ep = not eos and session.endpoint_detected()
        flags.append(ep)
        if ep or eos:
            segs.append((session.get_best_path()["words"],
                         session.num_frames_decoded))
            if ep:
                session.init_decoding()
    return flags, segs


def vad_info(dev, fst, i2p):
    """The phase's OnlineDecoderInfo on ``dev``: the flagship AM (seed 1)
    over 80 fbank + 3 pitch features, the energy VAD on."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.frontend.fbank import FbankConfig
    from asr_decoder_tpu_torch.frontend.pitch import (PitchConfig,
                                                      ProcessPitchConfig)
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    from asr_decoder_tpu_torch.models.nnet import AmConfig
    from asr_decoder_tpu_torch.serving.session import (OnlineDecoderConfig,
                                                       OnlineDecoderInfo)
    nnet = make_flagship(1, feat_dim=FEAT_DIM + PITCH_DIM,
                         num_pdfs=NUM_PDFS, device=dev)
    return OnlineDecoderInfo(
        nnet, fst, make_words(int(fst.arc_olabel.max())), i2p,
        DecoderConfig(**SEARCH),
        OnlineDecoderConfig(use_energy_vad=True, ctc_blank_shift=True),
        FbankConfig(num_bins=FEAT_DIM), AmConfig(skip=SKIP),
        pitch_config=PitchConfig(), process_pitch_config=ProcessPitchConfig(),
        device=dev)


def serve_vad(info, streams) -> tuple[list, float, object]:
    """Every stream over its own connection, each push awaited: (per
    stream [(reply, send time, reply time)], wall s, the server)."""
    from asr_decoder_tpu_torch.serving.client import AsyncAsrClient
    from asr_decoder_tpu_torch.serving.server import AsrServer, SocketConfig

    async def serve():
        server = AsrServer(info, SocketConfig(port=0,
                                              num_channels=len(streams)))
        host, port = await server.start()
        try:
            async def one(w, cuts):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    out = []
                    for lo, hi in cuts:
                        t0 = time.perf_counter()
                        r = await c.send_chunk(w[lo:hi], end=hi >= len(w))
                        out.append((r, t0, time.perf_counter()))
                    return out
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w, c) for w, c, _ in
                                          streams)), server
        finally:
            await server.stop()

    t0 = time.perf_counter()
    replies, server = asyncio.run(serve())
    return replies, time.perf_counter() - t0, server


def check_serve_vad(info, streams, replies) -> list[float]:
    """Every stream's replies against its card session: endpoint pushes,
    segment words, prefix + segment texts.  Returns each stream's (wall s
    from its first silent push to its first MIDDLEEND reply, that push's
    round trip)."""
    from asr_decoder_tpu_torch.serving.protocol import EndFlag
    from asr_decoder_tpu_torch.serving.session import OnlineDecoderSession
    lat = []
    for k, ((w, cuts, sil_at), rs) in enumerate(zip(streams, replies)):
        flags, segs = run_segments(OnlineDecoderSession(info), w, cuts)
        got = [r.end_flag == EndFlag.MIDDLEEND for r, _, _ in rs]
        check(got == flags, f"vad serve stream {k}: MIDDLEEND at the "
                            f"session's endpoint pushes")
        check(any(flags), f"vad serve stream {k}: at least one MIDDLEEND")
        check(rs[-1][0].end_flag == EndFlag.END, f"stream {k}: final END")
        done, words = 0, []
        for (r, _, _), ep in zip(rs, flags):
            if ep or r.end_flag == EndFlag.END:
                words = words + segs[done][0]
                done += 1
                check(r.results[0].words == words,
                      f"stream {k}: reply {done} = prefix + segment words")
        check(done == len(segs) and rs[-1][0].one_best() == " ".join(
            info.words.words(words)), f"stream {k}: final text = prefix + "
                                      f"last segment")
        first_sil = next(i for i, (lo, _) in enumerate(cuts)
                         if lo >= sil_at)
        ep = flags.index(True)
        lat.append((rs[ep][2] - rs[first_sil][1], rs[ep][2] - rs[ep][1]))
    return lat


def pitch_card_vs_cpu(dev, streams) -> dict:
    """StreamPitch on the card and on the CPU over CPU_STREAMS short
    streams (their first 2 s), the same pushes: every push's features
    within PITCH_TOL, the offline lag paths equal.  Then the card's ms per
    push along one whole stream and the Viterbi's kernels per push."""
    from asr_decoder_tpu_torch.frontend import pitch as P
    cfg, pcfg = P.PitchConfig(), P.ProcessPitchConfig()
    err = 0.0
    for w, cuts, _ in streams[:CPU_STREAMS]:
        short = w[:32000].astype(np.float32)
        sp = [P.StreamPitch(cfg, pcfg, device=d) for d in (dev, "cpu")]
        for lo, hi in cuts:
            if lo >= len(short):
                break
            end = hi >= len(short)
            g, c = (s.process_wave(short[None, lo:hi], end=end) for s in sp)
            check(g.shape == c.shape and np.allclose(
                g, c, atol=PITCH_TOL, rtol=PITCH_TOL),
                "pitch features card vs CPU within tolerance")
            if g.size:
                err = max(err, float(np.abs(g - c).max()))
        paths = [np.rint(cfg.resample_freq / P.compute_pitch(
            cfg, short[None], device=d)[0].cpu().numpy()).astype(int)
            for d in (dev, "cpu")]
        check(np.array_equal(*paths), "pitch Viterbi lag paths card == CPU")
    w, cuts, _ = streams[0]
    sp = P.StreamPitch(cfg, pcfg, device=dev)
    ms = []
    for lo, hi in cuts:
        t0 = time.perf_counter()
        sp.process_wave(w[None, lo:hi].astype(np.float32),
                        end=hi >= len(w))
        ms.append((hi / 16000, 1e3 * (time.perf_counter() - t0)))
    at = [min(ms, key=lambda m: abs(m[0] - t)) for t in (1.0, 2.0, 3.0)]
    wave = torch.from_numpy(w[None].astype(np.float32)).to(dev)
    nccf = P.compute_nccf(cfg, P.linear_resample(cfg, wave))[0]
    lags = cfg.lags().astype(np.float32)
    loglag = np.log(lags)
    trans = torch.from_numpy((cfg.penalty_factor * (
        loglag[:, None] - loglag[None, :]) ** 2).astype(np.float32)).to(dev)
    viterbi, vms, _ = profile_cuda(
        lambda: P._viterbi_track(1.0 - nccf, trans))
    push, pms, _ = profile_cuda(
        lambda: P.compute_and_process_pitch(cfg, pcfg, wave))
    T = nccf.shape[1]
    print(f"vad pitch: card == CPU over {CPU_STREAMS} streams of 2 s in "
          f"their pushes (max abs err {err:.2e}, tolerance {PITCH_TOL}), "
          f"lag paths equal; card ms per push "
          + ", ".join(f"{m:.2f} at {t:.2f} s" for t, m in at + ms[-1:])
          + f" (the whole wave re-run each push; {sum(m for _, m in ms):.1f}"
          f" ms over the stream's {len(ms)} pushes); at {T} frames the "
          f"Viterbi is {viterbi} "
          f"kernels ({viterbi / max(T - 1, 1):.2f} a frame, {vms:.3f} device "
          f"ms) of the push's {push} ({pms:.3f} device ms)")
    return dict(err=err, ms_at_1s=at[0][1], ms_at_end=ms[-1][1],
                viterbi_kernels=viterbi)


def phase_vad(dev, fst, i2p) -> dict:
    """The VAD-driven serve path (module docstring, item 8).  Returns the
    gather and fetch launches of its serve run."""
    from asr_decoder_tpu_torch.ops import fetch, gather
    from asr_decoder_tpu_torch.serving.protocol import EndFlag
    from asr_decoder_tpu_torch.serving.session import (FeatureBuffer,
                                                       OnlineDecoderSession)
    from asr_decoder_tpu_torch.serving.v1_session import V1AsrSession
    from asr_decoder_tpu_torch.vad import model_vad as MV
    from asr_decoder_tpu_torch.vad.energy import EnergyVadStream
    from asr_decoder_tpu_torch.wakeup import dtw
    from asr_decoder_tpu_torch.models.nnet import from_numpy_layers
    t_phase = time.perf_counter()
    streams = vad_streams()
    info = vad_info(dev, fst, i2p)
    # warm-up: one short push through a session (first-use costs)
    OnlineDecoderSession(info).process_data(
        streams[0][0][:16000].astype(np.float32), eos=True)
    gather.launches = fetch.launches = 0
    replies, wall, server = serve_vad(info, streams)
    launches = {"gather": gather.launches, "fetch": fetch.launches}
    check(launches["gather"] > 0 and launches["fetch"] > 0,
          f"vad serve: gather and fetch kernels launched ({launches})")
    lat = check_serve_vad(info, streams, replies)
    audio = sum(len(w) for w, _, _ in streams) / 16000
    middle = sum(r.end_flag == EndFlag.MIDDLEEND for rs in replies
                 for r, _, _ in rs)
    print(f"vad serve: {VAD_STREAMS} concurrent streams (83-dim fbank ‖ "
          f"pitch, energy VAD), {audio:.2f} audio-s in {wall:.3f} s wall "
          f"(RTF {wall / audio:.4f}), {server.dispatches} dispatches; "
          f"{middle} MIDDLEEND replies, every reply equal to its card "
          f"session (endpoint pushes, prefix + segment words); first silent "
          f"push -> MIDDLEEND reply {1e3 * np.median([a for a, _ in lat]):.1f}"
          f" ms median, {1e3 * max(a for a, _ in lat):.1f} ms max (the "
          f"endpoint push's own round trip "
          f"{1e3 * np.median([b for _, b in lat]):.1f} ms median); kernel "
          f"launches {launches}")

    # card == CPU: the energy VAD, every push of every stream
    vms = []
    for w, cuts, _ in streams:
        vads = [EnergyVadStream(info.vad_config, device=d)
                for d in (dev, "cpu")]
        for lo, hi in cuts:
            pcm = w[None, lo:hi].astype(np.float32)
            t0 = time.perf_counter()
            g = vads[0].accept(pcm, end=hi >= len(w))
            vms.append(1e3 * (time.perf_counter() - t0))
            check(np.array_equal(g, vads[1].accept(pcm, end=hi >= len(w))),
                  "energy VAD decisions card == CPU")
    print(f"vad energy: card == CPU over {sum(len(c) for _, c, _ in streams)}"
          f" pushes; card {np.mean(vms):.3f} ms per push (mean)")
    pitch = pitch_card_vs_cpu(dev, streams)

    # card == CPU: V1 sessions (silence never reaches the AM)
    cpu_info = vad_info(torch.device("cpu"), fst, i2p)
    same_words = 0
    for w, cuts, _ in streams[:CPU_STREAMS]:
        v1 = [V1AsrSession(i) for i in (info, cpu_info)]
        for s in v1:
            for lo, hi in cuts:
                s.process_data(w[lo:hi].astype(np.float32))
            s.process_data(np.zeros(0, np.float32), eos=True)
        g, c = ([(r["frame_span"], r["frames"]) for r in s.results]
                for s in v1)
        check(g == c and len(g) >= 2, f"V1 segments card == CPU ({g})")
        check(v1[0].frames_decoded() == v1[1].frames_decoded() and
              v1[0].frames_decoded() < v1[0].tot_nosil_frames
              + v1[0].tot_sil_frames, "V1 frames fed to the AM card == "
                                      "CPU, silence skipped")
        same_words += sum(a["words"] == b["words"] for a, b in
                          zip(*(s.results for s in v1)))
    print(f"vad v1: card == CPU over {CPU_STREAMS} streams: segments and "
          f"frames fed to the AM equal; words equal in {same_words} "
          f"segments (the AM differs in the last bits, phase 5)")
    del cpu_info

    # card == CPU: the nnet VAD over the streams' spliced features
    D = FEAT_DIM + PITCH_DIM
    w_sp = np.zeros(3 * D, np.float32)
    w_sp[np.tile(np.arange(D) < FEAT_DIM, 3)] = 1.0 / (3 * FEAT_DIM)
    layers = [("splice", D, 3 * D, (-1, 0, 1), {}),
              ("affine", 3 * D, 2, (), {"weight": np.stack([-w_sp, w_sp]),
                                        "bias": np.array([14.0, -14.0])}),
              ("softmax", 2, 2, (), {})]
    nv = [MV.VadNnet(from_numpy_layers(layers, device=d), [0], device=d)
          for d in (dev, "cpu")]
    judge = MV.VadJudgeConfig()
    frames = 0
    for w, _, _ in streams:
        feats = info.make_frontend().accept(w[None].astype(np.float32),
                                            end=True)[0]
        spliced = FeatureBuffer(1, 1, (-1, 0, 1)).accept(feats, end=True)
        st = [MV.VadNnetStream(v, judge) for v in nv]
        for lo in range(0, len(spliced), 37):
            end = lo + 37 >= len(spliced)
            g, c = (s.accept(spliced[None, lo:lo + 37], end=end) for s in st)
            check(np.array_equal(g, c), "nnet VAD decisions card == CPU")
        frames += len(spliced)
        check(0 < st[0].sil_frames and 0 < st[0].nosil_frames,
              "nnet VAD finds speech and silence")
    print(f"vad nnet: VadNnetStream decisions card == CPU over {frames} "
          f"frames of the streams' 83-dim features")

    # card == CPU: wakeup on posteriors with a keyword in noise
    rng = np.random.default_rng(12)
    tpl = rng.choice(NUM_PDFS, 6, replace=False)
    post = rng.dirichlet(np.ones(NUM_PDFS), 300).astype(np.float32)
    for j, s in enumerate(np.repeat(tpl, 8)):
        post[150 + j] *= 0.1
        post[150 + j, s] += 0.9
    ws = [dtw.WakeupSearch(dtw.WakeupConfig(), tpl, device=d)
          for d in (dev, "cpu")]
    fired = [s.process_data(post, end=True) for s in ws]
    check(fired[0] == fired[1] and fired[0] and ws[0].wake_range ==
          ws[1].wake_range, f"wakeup fires card == CPU ({ws[0].wake_range})")
    cost = rng.random((8, 100, 6)).astype(np.float32) * 8
    tg, dg = dtw.dtw_align(torch.from_numpy(cost).to(dev))
    tc, dc = dtw.dtw_align(torch.from_numpy(cost))
    derr = (dg.cpu() - dc).abs().max().item()
    check(torch.allclose(dg.cpu(), dc, atol=DTW_TOL, rtol=DTW_TOL) and
          abs(ws[0].confidence - ws[1].confidence) <= DTW_TOL,
          f"DTW costs card vs CPU (max abs err {derr})")
    print(f"vad wakeup: fires card == CPU at frames {ws[0].wake_range} "
          f"(confidence {ws[0].confidence:.6f} vs {ws[1].confidence:.6f}); "
          f"DTW [8,100,6] card vs CPU max abs err {derr:.2e} (tolerance "
          f"atol = rtol = {DTW_TOL}, totals up to {tc.max().item():.1f})")
    print(f"phase vad: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, pitch=pitch)


# ----------------------------------------------------------------------
# phase 9: the offline decode, eval and CTC-training path
# ----------------------------------------------------------------------

def start_tlg_build() -> subprocess.Popen:
    """Build the production point's composed TLG in a second process (host
    work only: ARPA text, parse, ``build_tlg``, ``DeviceFst.build``, the
    ε-closure), so it overlaps the earlier phases; it leaves the graph in
    the checkout's ``build/`` for ``tools/bench.py:production``."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "from asr_decoder_tpu_torch.tools.bench import build_or_load_tlg; "
         "build_or_load_tlg()"], stdout=subprocess.DEVNULL)


def counted(fn, label: str, need=("gather", "fetch"),
            tracebacks: int | None = 0) -> tuple:
    """``fn()`` with both search kernels' and the traceback kernel's
    counts set to 0 just before and read just after; the kernels in
    ``need`` must have launched, and the traceback kernel exactly
    ``tracebacks`` times (one a batch whose logs lie on the card; none
    where the logs are host copies; None: the caller checks).  Returns ``fn``'s result and
    {"gather", "fetch", "traceback": launches, "shapes": (the gather's,
    the fetch's launch shapes in that run)}."""
    from asr_decoder_tpu_torch.ops import fetch, gather, traceback
    gather.launches = fetch.launches = traceback.launches = 0
    gather.shapes, fetch.shapes = set(), set()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        shapes = (gather.shapes, fetch.shapes)
        gather.shapes = fetch.shapes = None
    n = {"gather": gather.launches, "fetch": fetch.launches,
         "traceback": traceback.launches, "shapes": shapes}
    check(all(n[k] > 0 for k in need),
          f"{label}: {' and '.join(need)} launched ({n})")
    check(tracebacks is None or n["traceback"] == tracebacks,
          f"{label}: traceback kernel launched {n['traceback']} times, "
          f"{tracebacks} expected")
    return out, n


def hold_launched_shapes(dev, n: dict, label: str) -> float:
    """Both kernels against their plain versions, bit-exact, at every shape
    the run counted in ``n`` launched them at: the gather on random tables
    of the launch's dtypes, the fetch on a random table of the launch's
    size with every token live and with mixed live counts, dead slots
    (negative states) among the tokens.  Launches made here are outside
    any counted run.  Returns the max abs err."""
    gen = torch.Generator(device=dev).manual_seed(9)
    gshapes, fshapes = (sorted(x, key=str) for x in n["shapes"])
    err = 0.0
    for B, V, N, types in gshapes:
        err = max(err, gather_exact(gen, dev, B, V, N, types)[2])
    for S, L in sorted({x[:2] for x in fshapes}):
        table = torch.randint(-2**31, 2**31 - 1, (S, L), generator=gen,
                              device=dev, dtype=torch.int32)
        for B, K in sorted(x[2:] for x in fshapes if x[:2] == (S, L)):
            state = torch.randint(0, S, (B, K), generator=gen, device=dev,
                                  dtype=torch.int32)
            state[:, 5::7] = -1
            full = torch.full((B,), K, dtype=torch.int32, device=dev)
            err = max(err, fetch_exact(table, state,
                                       (full, mixed_live(B, K, dev))))
        del table
    short = [f"[{B},{V}]x[{B},{N}] " + "+".join(str(t)[6:] for t in types)
             for B, V, N, types in gshapes]
    print(f"{label}: kernels == plain, bit-exact, at the shapes "
          f"this run launched: gather {', '.join(short)}; fetch "
          f"{', '.join(f'[{S},{L}] B={B} K={K}' for S, L, B, K in fshapes)}")
    return err


def same_paths(card: list, cpu: list, label: str) -> None:
    """Words, arc ids and costs of two tracebacks, bit for bit."""
    check(len(card) == len(cpu) and all(
        a["words"] == b["words"] and a["arc_ids"] == b["arc_ids"]
        and a["cost"] == b["cost"] for a, b in zip(card, cpu)),
        f"offline {label}: card words/arc ids/costs == CPU")


def offline_headline(dev) -> dict:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.frontend.fbank import compute_fbank
    from asr_decoder_tpu_torch.models.nnet import am_forward
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    from asr_decoder_tpu_torch.tools import bench
    run, n = counted(lambda: bench.headline(
        dev, pairs=OFFLINE_REPEATS, engines=False), "offline headline",
        tracebacks=1)
    r, k = run.report, run.keep
    check(r["batch"] == 256 and r["graph_states"] > GRAPH_STATES
          and r["effective_K"] == 512, f"headline at full size ({r})")
    R = OFFLINE_ROWS
    cpu = torch.device("cpu")
    net = copy.deepcopy(k["nnet"]).to(cpu)
    with torch.inference_mode():
        feats = compute_fbank(k["fb_cfg"], k["wave"][:R].cpu())
        ll_cpu, _ = am_forward(net.layers, feats, net.init_state(R, cpu),
                               skip=k["skip"])
    ll = k["ll"][:R].cpu()
    err = (ll - ll_cpu).abs().max().item()
    check(ll.shape == ll_cpu.shape and bool(torch.isfinite(ll).all())
          and err <= AM_ATOL,
          f"headline AM card vs CPU on {R} rows: max abs err {err}")
    cs = TorchBeamSearch(k["dev"], k["i2p"], DecoderConfig(**k["cfg_kw"]),
                         device=cpu)
    same_paths(k["results"][:R], cs.traceback(*cs.decode(ll), k["fst"]),
               "headline")
    check(all(np.isfinite(x["cost"]) for x in k["results"]),
          "headline: every row has a finite best path")
    print(f"offline headline (smoke figures, medians of {OFFLINE_REPEATS}): "
          f"B={r['batch']} x {r['wave_secs']:g} s, flagship 1024/512/3, "
          f"{r['graph_states']} states, K={r['effective_K']}, "
          f"T={r['frames']}: am_ms {r['am_ms']['median']}, search_ms "
          f"{r['search_ms']['median']} ({r['search_ms_per_frame']} "
          f"ms/frame), pipeline {r['pipeline_ms']['median']} ms = "
          f"{r['audio_s_per_s']['median']} audio-s per wall-s; live mean "
          f"{r['live_mean']}; K·F cut {r['kf_bind']}; traceback "
          f"{r['traceback_ms']} ms; AM card vs CPU max abs err {err:.2e} "
          f"on {R} rows, search card == CPU on them (words, costs); kernel "
          f"launches gather {n['gather']} fetch {n['fetch']} traceback "
          f"{n['traceback']}")
    n["max_abs_err"] = hold_launched_shapes(dev, n, "offline headline")
    return n


def offline_production(dev, tlg_proc: subprocess.Popen) -> dict:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    from asr_decoder_tpu_torch.tools import bench
    t0 = time.perf_counter()
    check(tlg_proc.wait(timeout=900) == 0, "the TLG build process exited 0")
    waited = time.perf_counter() - t0
    run, n = counted(lambda: bench.production(dev, pairs=OFFLINE_REPEATS),
                     "offline production", tracebacks=2)
    r, k = run.report, run.keep
    check(r["graph_cached"] and r["vocab"] == bench.TLG_FULL["vocab_size"]
          and r["graph_states"] > 2_000_000 and r["effective_K"] == 4096,
          f"production at full size ({r['graph_states']} states)")
    built, loaded = k["tlg"].dev, k["dev"]
    for name, a in vars(built).items():
        b = getattr(loaded, name)
        check(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b,
              f"DeviceFst save/load round trip: {name}")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cp, cm = pack_nonblank_frames(k["raw"].cpu(), 0,
                                  thresh=bench.BLANK_THRESH)
    check(torch.equal(k["packed"].cpu(), cp)
          and torch.equal(k["pmask"].cpu(), cm),
          "packing on the card == packing on the CPU")
    R = PROD_ROWS
    cs = TorchBeamSearch(loaded, k["tlg"].i2p, DecoderConfig(**k["cfg_kw"]),
                         device=cpu)
    same_paths(k["results"][:R],
               cs.traceback(*cs.decode(cp[:R], cm[:R]), k["tlg"].fst),
               "production")
    check(all(x["words"] for x in k["results"]),
          "production: every row decodes words")
    eq = r["words_packed_equal_unpacked"]
    print(f"offline production (smoke figures): composed TLG "
          f"{r['graph_states']} states, {r['graph_arcs']} arcs, vocab "
          f"{r['vocab']} (host build {r['graph_build_s']} + "
          f"{r['graph_device_build_s']} s in a second process, waited "
          f"{waited:.1f} s, cache read {r['graph_get_s']} s; save "
          f"{r['graph_save_s']}, load "
          f"{r['graph_load_s']}, upload {r['graph_upload_s']} s; round trip "
          f"equal); B={r['batch']} T={r['frames']} packed to "
          f"{r['packed_frames']} at blank prob > 0.75 "
          f"({r['packed_frames_at_log_0.95']} at 0.95), card == CPU "
          f"packing; K={r['effective_K']}: search_ms "
          f"{r['search_ms']['median']} ({r['search_ms_per_frame']} ms/frame)"
          f", unpacked {r['unpacked_search_ms']['median']} ms; words packed "
          f"== unpacked in {eq['equal']}/{eq['of']} rows; live mean "
          f"{r['live_mean']}; K·F cut {r['kf_bind']}; search card == CPU on "
          f"{R} rows ({time.perf_counter() - t0:.1f} s of CPU checks); "
          f"kernel launches gather {n['gather']} fetch {n['fetch']} "
          f"traceback {n['traceback']} (packed and unpacked)")
    n["max_abs_err"] = hold_launched_shapes(dev, n, "offline production")
    return n


def offline_realistic(dev) -> dict:
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    from asr_decoder_tpu_torch.tools import bench
    run, n = counted(lambda: bench.realistic(
        dev, pairs=OFFLINE_REPEATS, engines=False), "offline realistic",
        tracebacks=1)
    r, k = run.report, run.keep
    check(r["vocab"] == 30_000 and r["effective_K"] == 1024
          and all(x["words"] for x in k["results"]),
          "realistic at full size, every row decodes words")
    R = PROD_ROWS
    t0 = time.perf_counter()
    cs = TorchBeamSearch(k["dev"], k["i2p"], DecoderConfig(**k["cfg_kw"]),
                         device=torch.device("cpu"))
    same_paths(k["results"][:R],
               cs.traceback(*cs.decode(k["ll"][:R].cpu()), k["fst"]),
               "realistic")
    print(f"offline realistic (smoke figures): {r['graph_states']} states, "
          f"B={r['batch']} T={r['frames']} K={r['effective_K']}: search_ms "
          f"{r['search_ms']['median']} ({r['search_ms_per_frame']} ms/frame)"
          f"; K·F cut {r['kf_bind']}; search card == CPU on {R} rows (words,"
          f" arc ids, costs; {time.perf_counter() - t0:.1f} s of CPU "
          f"checks); kernel launches gather {n['gather']} fetch "
          f"{n['fetch']} traceback {n['traceback']}")
    n["max_abs_err"] = hold_launched_shapes(dev, n, "offline realistic")
    return n


def offline_eval(dev) -> dict:
    """The eval tool at its quick size on the card; then the decode it
    ran (``evaluate_wer``, kept from the tool's call) again with every
    runner's body called eagerly: the AM's log-likelihoods of the kept
    utterances bit for bit, words and errors equal, ``am_seconds`` of
    each."""
    from asr_decoder_tpu_torch.eval import harness
    from asr_decoder_tpu_torch.tools import eval as eval_tool
    real, calls = harness.evaluate_wer, []

    def keep(task, nnet, **kw):         # the tool's call, for the rerun
        calls.append((task, nnet, kw, real(task, nnet, **kw)))
        return calls[-1][-1]
    harness.evaluate_wer = keep
    try:
        out, n = counted(lambda: eval_tool.run(quick=True, steps=EVAL_STEPS,
                                               device=dev), "offline eval",
                         tracebacks=None)
    finally:
        harness.evaluate_wer = real
    d = out["detail"]
    check(d["gold_mismatches"] == 0 and d["gold_checked"] > 0,
          f"eval: device search == gold decoder ({d['gold_mismatches']} "
          f"mismatches)")
    check(out["value"] < EVAL_WER, f"eval: WER {out['value']} < {EVAL_WER}")
    ((task, nnet, kw, res),) = calls
    batches = -(-kw["num_utts"] // kw["batch"])
    check(n["traceback"] == batches, f"eval: traceback kernel launched "
          f"{n['traceback']} times, once for each of {batches} batches")
    with eager_graphs():
        eager = real(task, nnet, **kw)
    check(len(res.samples) == len(eager.samples) > 0 and all(
        np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
        and a[1:] == b[1:] for a, b in zip(res.samples, eager.samples))
        and res.wer.errors == eager.wer.errors,
        "eval: the AM and the search graph == eager, bit for bit")
    print(f"offline eval: quick task trained {d['train_steps']} steps on "
          f"the card in {d['train_s']} s ({d['train_steps_per_s']} "
          f"steps/s, one graph replay a step), ctc loss {d['ctc_loss']}; "
          f"{d['utts']} utterances decoded at effective K "
          f"{d['operating_point']['effective_K']}: WER {out['value']}, gold "
          f"mismatches {d['gold_mismatches']} of {d['gold_checked']}, RTF "
          f"{d['rtf']}; the AM (GraphedAm) == eager bit for bit on "
          f"{len(res.samples)} utterances, am_seconds graph "
          f"{res.am_seconds:.4f} vs eager {eager.am_seconds:.4f}; kernel "
          f"launches gather {n['gather']} fetch {n['fetch']} traceback "
          f"{n['traceback']}")
    n["max_abs_err"] = hold_launched_shapes(dev, n, "offline eval")
    return n


def train_batches(rng, n: int, T: int = TRAIN_T) -> list:
    """``n`` full-width CTC batches of ``TRAIN_B`` rows and ``T`` frames:
    8 to ``TRAIN_L`` labels a row, zero-padded."""
    batches = []
    for _ in range(n):
        x = rng.standard_normal((TRAIN_B, T, FEAT_DIM)).astype(np.float32)
        lens = rng.integers(8, TRAIN_L + 1, TRAIN_B)
        labels = rng.integers(1, NUM_PDFS, (TRAIN_B, TRAIN_L))
        pads = (np.arange(TRAIN_L)[None, :] >= lens[:, None]).astype(
            np.float32)
        batches.append((x, (labels * (1 - pads)).astype(np.int32), pads))
    return batches


def train_card_vs_cpu(dev, batches: list, label: str) -> tuple:
    """The full-width flagship (seed 5) stepped on ``batches`` on the card
    and on the CPU from the same weights: each loss finite and within
    ``TRAIN_RTOL``, the card's parameters finite.  Returns (card losses,
    CPU losses, card ms a step, the card model, its optimizer, state)."""
    from asr_decoder_tpu_torch.models.flagship import (ctc_train_step,
                                                       init_opt_state,
                                                       make_flagship)
    losses, ms = {}, []
    for d in (dev, torch.device("cpu")):
        net = make_flagship(5, feat_dim=FEAT_DIM, num_pdfs=NUM_PDFS,
                            device=d)
        opt = init_opt_state(net, 1e-3)
        state = net.init_state(TRAIN_B, d)
        out = []
        for b in batches:
            t0 = time.perf_counter()
            out.append(float(ctc_train_step(
                net, opt, *(torch.from_numpy(a).to(d) for a in b), state)))
            if d == dev:
                ms.append((time.perf_counter() - t0) * 1e3)
        losses["card" if d == dev else "cpu"] = out
        if d == dev:
            card = (net, opt, state)
    for g, c in zip(losses["card"], losses["cpu"]):
        check(np.isfinite(g) and abs(g - c) <= TRAIN_RTOL * abs(c),
              f"{label}: card loss {g} vs CPU loss {c} within {TRAIN_RTOL}")
    check(all(bool(torch.isfinite(p).all()) for p in card[0].parameters()),
          f"{label}: card parameters finite")
    return losses["card"], losses["cpu"], ms, *card


def offline_train(dev) -> None:
    """``TRAIN_STEPS`` CTC steps of the full-width flagship on the card
    (the first runs eagerly and captures, the rest replay) and on the CPU
    from the same weights and batches: each loss within ``TRAIN_RTOL``;
    ms a step and kernels of a replayed step on the card.  Then two steps
    at ``INFEASIBLE_T`` frames, the second batch's row 0 holding
    ``TRAIN_L`` labels: the card's replayed loss finite and within
    ``TRAIN_RTOL`` of the CPU's."""
    from asr_decoder_tpu_torch.models.flagship import ctc_train_step
    rng = np.random.default_rng(21)
    batches = train_batches(rng, TRAIN_STEPS + 1)
    card, cpu, ms, net, opt, state = train_card_vs_cpu(
        dev, batches[:TRAIN_STEPS], "train")
    b = [torch.from_numpy(a).to(dev) for a in batches[TRAIN_STEPS]]
    kernels, _, calls = profile_cuda(
        lambda: ctc_train_step(net, opt, *b, state))
    print(f"offline train: flagship 1024/512/3, {NUM_PDFS} pdfs, "
          f"B={TRAIN_B} T={TRAIN_T}: losses card {card} == CPU {cpu} within "
          f"{TRAIN_RTOL} relative; card ms per step "
          f"{[round(m, 1) for m in ms]} (the first runs eagerly and "
          f"captures), {kernels} kernels and {calls} host CUDA calls a "
          f"replayed step")
    feasible, infeasible = train_batches(rng, 2, INFEASIBLE_T)
    infeasible[1][0] = rng.integers(1, NUM_PDFS, TRAIN_L)
    infeasible[2][0] = 0.0
    card, cpu, _, *_ = train_card_vs_cpu(dev, [feasible, infeasible],
                                         "train infeasible")
    print(f"offline train infeasible: B={TRAIN_B} T={INFEASIBLE_T}, row 0 "
          f"of the second batch {TRAIN_L} labels: losses card {card} == "
          f"CPU {cpu} within {TRAIN_RTOL} relative (the second a replay), "
          f"parameters finite")


def graph_train(dev) -> None:
    """The "graphs train" line (module docstring, phase 9)."""
    from asr_decoder_tpu_torch.models.flagship import (ctc_loss,
                                                       ctc_train_step,
                                                       flagship_logits,
                                                       init_opt_state,
                                                       make_flagship)
    from asr_decoder_tpu_torch.ops import fetch, gather
    t_line = time.perf_counter()
    batches = [[torch.from_numpy(a).to(dev) for a in b] for b in
               train_batches(np.random.default_rng(22), TRAIN_GRAPH_BATCHES)]
    names = ("graph", "eager", "eager2")
    nets = {k: make_flagship(5, feat_dim=FEAT_DIM, num_pdfs=NUM_PDFS,
                             device=dev) for k in names}
    opts = {k: init_opt_state(nets[k], 1e-3) for k in names}
    state = nets["graph"].init_state(TRAIN_B, dev)

    def step(name: str, b) -> tuple:
        with nullcontext() if name == "graph" else eager_graphs():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = ctc_train_step(nets[name], opts[name], *b, state)
            torch.cuda.synchronize()
        return loss, (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def apart(a: str, b: str, losses: dict) -> tuple[bool, float]:
        pairs = [(losses[a], losses[b]), *zip(nets[a].parameters(),
                                               nets[b].parameters())]
        return (all(torch.equal(x, y) for x, y in pairs),
                max(float((x - y).abs().max()) for x, y in pairs))

    before = (gather.launches, fetch.launches)
    ms = {"graph": [], "eager": []}
    bitwise = eager_bitwise = 0
    worst = {"graph": 0.0, "eager2": 0.0}
    graph_losses = []
    for i, b in enumerate(batches):
        losses = {}
        for name in ("graph", "eager")[::1 if i % 2 == 0 else -1]:
            losses[name], t = step(name, b)
            if i:
                ms[name].append(t)
        losses["eager2"], _ = step("eager2", b)
        graph_losses.append(float(losses["graph"]))
        check(np.isfinite(graph_losses[-1]),
              f"graphs train: step {i} loss finite")
        g_same, g_err = apart("graph", "eager", losses)
        e_same, e_err = apart("eager2", "eager", losses)
        check(g_same if e_same else g_err <= e_err,
              f"graphs train step {i}: graph {g_err} from eager, no further "
              f"than eager from eager {e_err} (bit for bit where eager is)")
        bitwise += g_same
        eager_bitwise += e_same
        worst = {"graph": max(worst["graph"], g_err),
                 "eager2": max(worst["eager2"], e_err)}
    check((gather.launches, fetch.launches) == before,
          "graphs train: the search kernels' counters unmoved")
    b = batches[0]
    _, dev_ms, calls = profile_cuda(
        lambda: ctc_train_step(nets["graph"], opts["graph"], *b, state))
    with eager_graphs():
        kernels, eager_dev_ms, eager_calls = profile_cuda(
            lambda: ctc_train_step(nets["eager"], opts["eager"], *b, state))
    with torch.no_grad():
        logits = flagship_logits(nets["eager"].layers, b[0], state)[0]
    logits.requires_grad_(True)

    def loss_alone():
        with torch.enable_grad():
            ctc_loss(logits, b[1], b[2]).mean().backward()
    loss_kernels, loss_ms, _ = profile_cuda(loss_alone)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    wins = sum(a < e for a, e in zip(ms["graph"], ms["eager"]))
    n = len(batches)
    print(f"graphs train: flagship 1024/512/3 B={TRAIN_B} T={TRAIN_T}, {n} "
          f"steps: graph == eager bit for bit at {bitwise}/{n} steps (eager "
          f"== eager at {eager_bitwise}/{n}; max abs apart graph "
          f"{worst['graph']:.3e}, eager {worst['eager2']:.3e}), loss "
          f"{graph_losses[0]:.4f} -> {graph_losses[-1]:.4f}; search kernel "
          f"counters unmoved; ms/step graph {med['graph']:.3f} "
          f"[{min(ms['graph']):.3f}, {max(ms['graph']):.3f}] vs eager "
          f"{med['eager']:.3f} [{min(ms['eager']):.3f}, "
          f"{max(ms['eager']):.3f}] in {len(ms['graph'])} alternating pairs "
          f"(graph faster in {wins}); host CUDA calls/step {calls} vs "
          f"{eager_calls}; device ms/step {dev_ms:.3f} vs {eager_dev_ms:.3f} "
          f"({kernels} kernels); card busy {100 * dev_ms / med['graph']:.1f}%"
          f" vs {100 * eager_dev_ms / med['eager']:.1f}%; the CTC loss "
          f"(forward and backward, {loss_kernels} kernels) {loss_ms:.3f} "
          f"device ms = {100 * loss_ms / eager_dev_ms:.1f}% of the step; "
          f"{time.perf_counter() - t_line:.1f} s")


def phase_offline(dev, tlg_proc: subprocess.Popen) -> dict:
    """Returns the search kernels' and the traceback kernel's launches
    over the three points and the eval run, and the max abs err of the
    search kernels against their plain versions at the shapes those runs
    launched them at."""
    t0 = time.perf_counter()
    counts = []
    for fn in (offline_headline, lambda d: offline_production(d, tlg_proc),
               offline_realistic, offline_eval):
        counts.append(fn(dev))
        torch.cuda.empty_cache()
        print(f"phase offline: at {time.perf_counter() - t0:.1f} s")
    offline_train(dev)
    graph_train(dev)
    print(f"phase offline: {time.perf_counter() - t0:.1f} s")
    out = {k: sum(c[k] for c in counts)
           for k in ("gather", "fetch", "traceback")}
    out["max_abs_err"] = max(c["max_abs_err"] for c in counts)
    return out


# ----------------------------------------------------------------------
# phase 10: multi-device (one card playing every mesh device) and native
# ----------------------------------------------------------------------

def same_run(a, b) -> bool:
    """Every leaf of two (state, init log, frame logs) triples, bit for
    bit."""
    return all(torch.equal(*(t.view(torch.int32) if t.dtype == torch.float32
                             else t for t in (x.cpu(), y.cpu())))
               for p, q in zip(a, b) for x, y in zip(p, q))


def timed(fn) -> tuple:
    """(``fn()``, its wall seconds to the card's last kernel)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def multi_dp_decode(dev, search, fst) -> dict:
    """The smoke search (phase 4's loglikes, 16 streams, K = 512) unsharded
    and dp-sharded over ``DP_MESHES`` meshes of the one card: every leaf
    bit-identical, ms/frame and kernel launches of each."""
    from asr_decoder_tpu_torch.parallel.decode import dp_decode
    from asr_decoder_tpu_torch.parallel.mesh import make_mesh
    ll = torch.from_numpy(fixed_loglikes(FRAMES)).to(dev)
    search.decode(ll[:, :4])                              # warm-up
    (want, sec), n = counted(lambda: timed(lambda: search.decode(ll)),
                             "dp decode, dp = 1")
    ref = search.traceback(*want, fst)
    runs = {1: dict(ms_per_frame=1e3 * sec / FRAMES, n=n)}
    for dp in DP_MESHES:
        mesh = make_mesh([dev] * dp)
        dp_decode(mesh, search, ll[:, :4])                # warm-up
        (got, sec), n = counted(lambda: timed(
            lambda: dp_decode(mesh, search, ll)), f"dp decode, dp = {dp}")
        check(same_run(got, want) and search.traceback(*got, fst) == ref,
              f"dp = {dp} decode: logs, words and costs bit-identical to "
              f"the unsharded card decode")
        runs[dp] = dict(ms_per_frame=1e3 * sec / FRAMES, n=n)
    print(f"multi dp decode: {BATCH} streams x {FRAMES} frames, K = "
          f"{search.beam_width}, {search.dev.num_states} states; dp = "
          f"{' and '.join(map(str, DP_MESHES))} on one card: logs, words and "
          f"costs bit-identical to the unsharded decode; " + "; ".join(
              f"dp = {dp}: {r['ms_per_frame']:.3f} ms/frame, launches "
              f"gather {r['n']['gather']} fetch {r['n']['fetch']}"
              for dp, r in runs.items()))
    return runs


def am_rows_err(dev, info) -> dict:
    """The AM (``info.score``) over one chunk of ``UTTS // 2`` channels
    alone against the same rows of the ``UTTS``-row call, on the card and
    on the CPU: max abs err of each (0 where the rows' products do not
    depend on the batch)."""
    from asr_decoder_tpu_torch.parallel.mesh import replicate_layers
    C, n = info.config.chunk_frames, UTTS // 2
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (UTTS, C, info.am_layers[0].input_dim)).astype(np.float32))
    valid = np.full(UTTS, C, np.int32)
    out = {}
    for name, d, layers in (("card", dev, info.am_layers),
                            ("cpu", torch.device("cpu"),
                             replicate_layers(info.am_layers, "cpu"))):
        with torch.inference_mode():
            def score(b):
                return info.score(x[:b].to(d), [l.init_state(b, d)
                                                for l in layers],
                                  valid[:b], layers)[0][:n]
            out[name] = float((score(UTTS) - score(n)).abs().max())
    return out


def multi_dp_arena(dev, info) -> tuple:
    """Phase 6's ``UTTS`` 4-s streams through the dp = 2 arena and the
    unsharded one: every best path equal, costs within ``ARENA_COST_RTOL``
    of their size.  Returns the dp run's kernel launches and the unsharded
    arena with its channel ids."""
    from asr_decoder_tpu_torch.parallel.mesh import make_mesh
    from asr_decoder_tpu_torch.serving.batcher import BatchedStreamingDecoder
    n = int(16000 * UTT_SECONDS)
    waves = serve_waves(UTTS, UTT_SECONDS)
    am_err = am_rows_err(dev, info)

    def run(mesh):
        eng = BatchedStreamingDecoder(info, UTTS, mesh=mesh)
        cids = [eng.acquire() for _ in waves]
        for off in range(0, n, CHUNK):
            for cid, w in zip(cids, waves):
                eng.push(cid, w[off:off + CHUNK].astype(np.float32),
                         eos=off + CHUNK >= n)
        eng.drain()
        return eng, cids, [eng.get_best_path(c) for c in cids]

    def loglikes(eng, cids):
        return [np.concatenate(eng.snapshot(c).loglikes) for c in cids]
    (eng, cids, want), sec0 = timed(lambda: run(None))
    (dp_run, sec), n_dp = counted(lambda: timed(
        lambda: run(make_mesh([dev] * 2))), "dp arena")
    got = dp_run[2]
    # each stream's AM outputs in the two arenas: Σ over frames of the
    # largest difference bounds what they can move a path's cost
    dll = [np.abs(a - b).max(axis=1) for a, b in
           zip(loglikes(*dp_run[:2]), loglikes(eng, cids))]
    del dp_run
    dcost = [abs(g["cost"] - w["cost"]) for g, w in zip(got, want)]
    rel = max(d / abs(w["cost"]) for d, w in zip(dcost, want))
    mag = [abs(w["cost"]) for w in want]
    explained = max(d / max(float(x.sum()), 1e-30) for d, x in zip(dcost, dll))
    print(f"multi dp arena: {UTTS} streams of {UTT_SECONDS:g} s through "
          f"BatchedStreamingDecoder(mesh=dp 2) on one card: costs within "
          f"{max(dcost):.3e} abs, {rel:.3e} of |cost| ({min(mag):.1f}-"
          f"{max(mag):.1f}; tolerance {ARENA_COST_RTOL}); the AM over rows "
          f"0-{UTTS // 2 - 1} alone against the same rows of the {UTTS}-row "
          f"call (one chunk from zero state): max abs err card "
          f"{am_err['card']:.3e}, CPU {am_err['cpu']:.3e}; the two arenas' "
          f"AM outputs a frame differ by up to {max(x.max() for x in dll):.3e}"
          f", summed over a stream's frames up to "
          f"{max(x.sum() for x in dll):.3e}; each stream's cost difference "
          f"at most {explained:.3f} of its sum; words in utt 0: "
          f"{len(want[0]['words'])}; {sec:.3f} s against {sec0:.3f} s "
          f"unsharded; launches gather {n_dp['gather']} fetch "
          f"{n_dp['fetch']}")
    check(all(g["words"] == w["words"] and g["arc_ids"] == w["arc_ids"]
              for g, w in zip(got, want)) and rel <= ARENA_COST_RTOL,
          f"dp = 2 arena: {UTTS}/{UTTS} best paths (words, arc ids) equal "
          f"the unsharded arena, costs within {rel} <= {ARENA_COST_RTOL} of "
          f"|cost|")
    return n_dp, eng, cids


def multi_biglm(dev, search, fst) -> dict:
    """Phase 7's BigLM search at its depth, unsharded and dp = 2."""
    from asr_decoder_tpu_torch.parallel.decode import dp_decode
    from asr_decoder_tpu_torch.parallel.mesh import make_mesh
    ll = torch.from_numpy(fixed_loglikes(GT_FRAMES, seed=7)).to(dev)
    mesh = make_mesh([dev] * 2)
    search.decode(ll[:, :4])                              # warm-up
    dp_decode(mesh, search, ll[:, :4])
    want, sec0 = timed(lambda: search.decode(ll))
    (got, sec), n = counted(
        lambda: timed(lambda: dp_decode(mesh, search, ll)),
        "biglm dp decode", need=("gather",))
    check(same_run(got, want) and search.traceback(*got, fst) ==
          search.traceback(*want, fst),
          "biglm dp = 2: logs, LM lanes, overflow flags, words and costs "
          "bit-identical to the unsharded card decode")
    ovf = [int(r[2].overflow.sum()) for r in (want, got)]
    print(f"multi biglm: dp = 2 on one card == unsharded ({BATCH}x"
          f"{GT_FRAMES} frames): every leaf bit-identical, overflow "
          f"{ovf[1]} == {ovf[0]} utterance-frames; {1e3 * sec / GT_FRAMES:.3f}"
          f" against {1e3 * sec0 / GT_FRAMES:.3f} ms/frame; gather launches "
          f"{n['gather']}")
    return n


def multi_tp_am(dev, search, fst) -> None:
    """The full-width flagship with its affine rows split over tp = 2 on
    one card: allclose to the unsharded AM, and the decode over its
    posteriors gives the same words."""
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    from asr_decoder_tpu_torch.models.nnet import am_forward
    from asr_decoder_tpu_torch.parallel.mesh import (gather_batch, make_mesh,
                                                     shard_model,
                                                     sharded_forward)
    nnet = make_flagship(0, feat_dim=FEAT_DIM, num_pdfs=NUM_PDFS, device=dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, 3 * FRAMES, FEAT_DIM)).astype(np.float32)).to(dev)
    model = shard_model(make_mesh([dev] * 2, tp=2), nnet.layers)
    with torch.inference_mode():
        am_forward(nnet.layers, x[:, :6], nnet.init_state(BATCH, dev),
                   skip=SKIP)                             # warm-up
        sharded_forward(model, x[:, :6], skip=SKIP)
        y0, sec0 = timed(lambda: am_forward(
            nnet.layers, x, nnet.init_state(BATCH, dev), skip=SKIP)[0])
        y1, sec = timed(lambda: gather_batch(
            sharded_forward(model, x, skip=SKIP)[0], dev))
    err = (y1 - y0).abs().max().item()
    check(y1.shape == y0.shape and err <= AM_ATOL,
          f"tp = 2 AM max abs err {err} <= {AM_ATOL}")
    w0 = [r["words"] for r in search.traceback(*search.decode(y0), fst)]
    w1 = [r["words"] for r in search.traceback(*search.decode(y1), fst)]
    check(w0 == w1, "decode over the tp AM's posteriors: same words")
    print(f"multi tp am: flagship {nnet.layers[2].w_r_m.shape[1]}/"
          f"{nnet.layers[2].output_dim}/{len(nnet.layers) - 5} with its "
          f"affine rows split over tp = 2 on one card: max abs err "
          f"{err:.3e} against the unsharded AM (tolerance {AM_ATOL}); "
          f"{sec:.3f} s against {sec0:.3f} s; decode words equal for "
          f"{len(w0)} utterances")


def start_nccl_selftest() -> tuple:
    """The one-rank NCCL selftest (``run_distributed_selftest(1,
    backend="nccl")``: a worker process that initialises NCCL on the card)
    in a thread, so its process start overlaps the phase's other work.
    Returns (thread, result dict)."""
    import threading
    from asr_decoder_tpu_torch.parallel.multihost import \
        run_distributed_selftest
    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            out["ok"] = run_distributed_selftest(
                1, timeout=NCCL_TIMEOUT_S, backend="nccl")[0]
        except Exception as e:                     # reported by multi_hosts
            out["ok"] = repr(e)
        out["s"] = time.perf_counter() - t0
    thread = threading.Thread(target=run)
    thread.start()
    return thread, out


def multi_hosts(dev, info, nccl) -> None:
    """Two simulated hosts, each an arena over its own dp = 2 mesh of the
    card, against per-stream sessions; host 0 dropped mid-run.  Then the
    one-rank NCCL selftest started by ``start_nccl_selftest``."""
    from asr_decoder_tpu_torch.parallel.multihost import \
        simulated_host_arenas
    from asr_decoder_tpu_torch.serving.session import OnlineDecoderSession
    rng = np.random.default_rng(31)
    waves = [(rng.standard_normal(int(16000 * GT_SECONDS)) * 4000)
             .astype(np.float32) for _ in range(2)]
    want = []
    for w in waves:
        s = OnlineDecoderSession(info)
        s.process_data(w, eos=True)
        want.append(s.get_best_path()["words"])
    arenas = simulated_host_arenas(lambda: info, 2, num_channels=4,
                                   devices=[dev] * 4)
    cids = [a.acquire() for a in arenas]
    for arena, cid, w in zip(arenas, cids, waves):
        arena.push(cid, w, eos=True)
    arenas[0].drain()
    got0 = arenas[0].get_best_path(cids[0])["words"]
    # a second stream on host 0, then "host 0 dies": host 1 drains alone
    arenas[0].push(arenas[0].acquire(), waves[0], eos=True)
    arenas[0] = None
    arenas[1].drain()
    got1 = arenas[1].get_best_path(cids[1])["words"]
    check([got0, got1] == want, "per-host arenas == per-stream sessions, "
                                "host 1 unaffected by host 0's loss")
    thread, out = nccl
    thread.join()
    check(out["ok"].startswith("MH_OK"), f"NCCL selftest: {out['ok']}")
    print(f"multi hosts: 2 simulated hosts x dp 2 on one card == per-stream "
          f"sessions, host 1 unaffected when host 0 is dropped; NCCL "
          f"selftest with 1 rank in {out['s']:.1f} s (a process of its own, "
          f"overlapping this phase): {out['ok']}; NCCL refuses two ranks on "
          f"one GPU, so more ranks wait for a machine with more cards")


def multi_nbest(info, eng, cids) -> None:
    """The native n-best against the Python one on the determinized
    lattices of ``NATIVE_UTTS`` of phase 6's utterances (decoded by the
    unsharded arena ``eng``): equal results, and the ms of a reply both
    ways as the session and the batcher reach it (``nbest_from_lattice``,
    which serializes the lattice for the native library) and as the post
    service does (on the bytes it makes for its reply in any case)."""
    from asr_decoder_tpu_torch.fst import native_nbest
    from asr_decoder_tpu_torch.fst.nbest import nshortest
    from asr_decoder_tpu_torch.serving.session import nbest_from_lattice
    check(native_nbest.available(), "the native n-best library builds")
    lib = native_nbest._lib
    ms = {k: [] for k in ("to_bytes", "post_native", "post_python",
                          "native", "python")}
    states = []
    for cid in cids[:NATIVE_UTTS]:
        lat = eng.get_lattice_from(eng.snapshot(cid, logs=True),
                                   determinize=True)
        data, sec = timed(lat.to_bytes)
        ms["to_bytes"].append(1e3 * sec)
        got, sec = timed(lambda: native_nbest.nshortest_bytes(data, NBEST_N))
        ms["post_native"].append(1e3 * sec)
        paths, sec = timed(lambda: nshortest(lat, NBEST_N))
        ms["post_python"].append(1e3 * sec)
        check(len(got) == len(paths) > 0 and all(
            g["words"] == [a.olabel for a in p.arcs if a.olabel]
            and g["ilabels"] == list(p.ilabels)
            and abs(g["graph_cost"] - p.graph_cost) <= 1e-3
            and abs(g["am_cost"] - p.am_cost) <= 1e-3
            for g, p in zip(got, paths)),
            "native n-best == Python n-best (words, ilabels, costs)")
        native, sec = timed(lambda: nbest_from_lattice(info, lat, NBEST_N))
        ms["native"].append(1e3 * sec)
        native_nbest._lib = lambda: None       # the no-toolchain fallback
        try:
            python, sec = timed(lambda: nbest_from_lattice(info, lat,
                                                           NBEST_N))
        finally:
            native_nbest._lib = lib
        ms["python"].append(1e3 * sec)
        check([r["text"] for r in native] == [r["text"] for r in python],
              "nbest_from_lattice: native texts == Python texts")
        states.append(lat.num_states)
    f = "/".join
    print(f"multi native: n-best (n = {NBEST_N}) native == Python on "
          f"{len(states)} determinized lattices of {f(map(str, states))} "
          f"states, ms per reply each: session/batcher (nbest_from_lattice) "
          f"native {f(f'{t:.2f}' for t in ms['native'])} (to_bytes alone "
          f"{f(f'{t:.2f}' for t in ms['to_bytes'])}) against Python "
          f"{f(f'{t:.2f}' for t in ms['python'])}; post service (bytes "
          f"made for its reply) native "
          f"{f(f'{t:.2f}' for t in ms['post_native'])} against Python "
          f"{f(f'{t:.2f}' for t in ms['post_python'])}")


def multi_native_client(info) -> None:
    """The C++ client against the Python client through the port's server
    on ``NATIVE_UTTS`` of phase 6's waves: texts and word alignments
    equal."""
    from asr_decoder_tpu_torch.serving.client import AsyncAsrClient
    from asr_decoder_tpu_torch.serving.native_client import NativeAsrClient
    from asr_decoder_tpu_torch.serving.server import AsrServer, SocketConfig
    waves = serve_waves(UTTS, UTT_SECONDS)[:NATIVE_UTTS]

    async def serve():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            def native_work():
                out = []
                for w in waves:
                    with NativeAsrClient(host, port) as c:
                        for off in range(0, len(w), CHUNK):
                            text, _ = c.send_chunk(
                                w[off:off + CHUNK], ali_info=True,
                                eos=off + CHUNK >= len(w))
                        out.append((text, c.last_align))
                return out
            native = await asyncio.to_thread(native_work)
            python = []
            for w in waves:
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    python.append(await c.decode_utterance(
                        w, chunk_samples=CHUNK, ali_info=True))
                finally:
                    await c.close()
            return native, python
        finally:
            await server.stop()

    native, python = asyncio.run(serve())
    check(all(t == r.one_best() and [a[0] for a in al] ==
              [a[0] for a in r.align] and np.allclose(
                  [a[1:] for a in al], [a[1:] for a in r.align], atol=1e-3)
              for (t, al), r in zip(native, python)),
          "native client texts and word alignments == the Python client's")
    print(f"multi native client: NativeAsrClient texts and alignments == "
          f"the Python client's for {len(waves)} utterances (words in utt 0: "
          f"{len(native[0][0].split())})")


def phase_multi(dev, fst, serve_info, biglm_search) -> dict:
    """Phase 10; returns the search kernels' launches of its counted runs
    and their max abs err against the plain versions at every shape those
    runs launched them at."""
    from asr_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    runs = multi_dp_decode(dev, serve_info.search, fst)
    counts = [runs[dp]["n"] for dp in DP_MESHES]
    n_arena, eng, cids = multi_dp_arena(dev, serve_info)
    counts.append(n_arena)
    counts.append(multi_biglm(dev, biglm_search, fst))
    multi_tp_am(dev, serve_info.search, fst)
    multi_nbest(serve_info, eng, cids)
    del eng
    # the timed runs are done: the NCCL worker may start beside the rest
    nccl = start_nccl_selftest()
    shapes = ({s for c in counts for s in c["shapes"][0]},
              {s for c in counts for s in c["shapes"][1]})
    err = hold_launched_shapes(dev, {"shapes": shapes}, "multi dp runs")
    multi_native_client(serve_info)
    multi_hosts(dev, serve_info, nccl)
    out = dryrun_multichip(4, [dev] * 4)
    check(out["mesh"] == {"dp": 2, "tp": 2}, f"dry run mesh {out['mesh']}")
    print(f"phase multi: {time.perf_counter() - t0:.1f} s")
    return dict(gather=sum(c["gather"] for c in counts),
                fetch=sum(c["fetch"] for c in counts), max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    print(smi.strip().splitlines()[0])
    t0 = time.perf_counter()
    tlg_proc = start_tlg_build()
    try:
        return run_phases(dev, name, t0, tlg_proc)
    finally:
        if tlg_proc.poll() is None:         # a phase failed before phase 9
            tlg_proc.kill()
            tlg_proc.wait()


def run_phases(dev, name: str, t0: float, tlg_proc) -> int:
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    kernels = phase_kernels(dev)
    print(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    rows = phase_rows(dev)
    print(f"phase rows done at {time.perf_counter() - t0:.1f} s")
    fst, i2p = make_graph()
    v3 = phase_search(dev, fst, i2p)
    check(v3["launches"]["fetch"] > 0, "fetch kernel launched by v3")
    # emit: acoustic lookup, top-K·F dst, ε bit, ε-first order, winners
    # (cost, state, index); closure: top-K·F dst, winners (state, index)
    check(v3["gather_per_frame"] == V3_GATHERS_PER_FRAME,
          f"v3 gather launches a frame {v3['gather_per_frame']} == "
          f"{V3_GATHERS_PER_FRAME}")
    for mode in ("closure", "sweeps"):
        v2 = phase_search(dev, fst, i2p, frames=V2_FRAMES, eps_mode=mode,
                          relax_impl="sort")
        check(v2["launches"]["gather"] > 0,
              f"gather kernel launched by v2 {mode}")
    print(f"phase search done at {time.perf_counter() - t0:.1f} s")
    nnet = make_flagship(0, feat_dim=FEAT_DIM, num_pdfs=NUM_PDFS,
                         device=dev)
    phase_am(dev, nnet)
    print(f"phase am done at {time.perf_counter() - t0:.1f} s")
    launches, serve_info = phase_serve(dev, nnet, fst)
    print(f"phase serve done at {time.perf_counter() - t0:.1f} s")
    graph_types = phase_graph_types(dev, nnet, fst, i2p)
    print(f"phase graph types done at {time.perf_counter() - t0:.1f} s")
    del nnet
    vad = phase_vad(dev, fst, i2p)["launches"]
    print(f"phase vad done at {time.perf_counter() - t0:.1f} s")
    offline = phase_offline(dev, tlg_proc)
    print(f"phase offline done at {time.perf_counter() - t0:.1f} s")
    multi = phase_multi(dev, fst, serve_info,
                        graph_types.pop("biglm_search"))
    print(f"phase multi done at {time.perf_counter() - t0:.1f} s")
    check_imports()
    # the search kernels' main-path launches: the serve run and the
    # decode CLI's run, the graph
    # types' card searches and serve runs, the VAD-driven serve run, the
    # three offline points, the eval run, and phase 10's dp decodes, dp
    # arena and BigLM dp decode (each counted from 0 just before)
    kernels["gather"]["max_abs_err"] = max(
        kernels["gather"]["max_abs_err"], launches["max_abs_err"],
        graph_types["max_abs_err"], offline["max_abs_err"],
        multi["max_abs_err"])
    kernels["fetch"]["max_abs_err"] = max(kernels["fetch"]["max_abs_err"],
                                          launches["max_abs_err"],
                                          offline["max_abs_err"],
                                          multi["max_abs_err"])
    record = {"kernels": [
        dict(name="batched_table_gather", route="cuda",
             source="asr_decoder_tpu_torch/csrc/gather.cu",
             replaces="asr_decoder_tpu/ops/gather.py:43",
             launches=(launches["gather"] + graph_types["gather"]
                       + vad["gather"] + offline["gather"]
                       + multi["gather"]),
             **kernels["gather"]),
        dict(name="fetch_records", route="cuda",
             source="asr_decoder_tpu_torch/csrc/fetch.cu",
             replaces="asr_decoder_tpu/ops/fetch.py:65",
             launches=(launches["fetch"] + vad["fetch"] + offline["fetch"]
                       + multi["fetch"]),
             **kernels["fetch"]),
        dict(name="make_dma_gather", route="cuda",
             source="asr_decoder_tpu_torch/csrc/fetch.cu",
             replaces="tools/perf/bench_row_gather.py:38",
             **rows["make_dma_gather"]),
        dict(name="make_dma", route="cuda",
             source="asr_decoder_tpu_torch/csrc/fetch.cu",
             replaces="tools/perf/bench_dma_variants.py:22",
             **rows["make_dma"]),
        dict(name="make_dma_dyn", route="cuda",
             source="asr_decoder_tpu_torch/csrc/fetch.cu",
             replaces="tools/perf/bench_dma_variants.py:63",
             **rows["make_dma_dyn"]),
        dict(name="traceback_best_paths", route="cuda",
             source="asr_decoder_tpu_torch/csrc/traceback.cu",
             replaces=None, launches=offline["traceback"],
             **kernels["traceback"]),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
