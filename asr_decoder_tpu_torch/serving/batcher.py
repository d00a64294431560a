"""Batched multi-stream decoding: channel arena + dynamic batcher.

Port of ``asr_decoder_tpu/serving/batcher.py``: many streaming channels
packed into one AM forward + one search advance per tick (ref:
src/gpu-asr/v1-gpu-kaldi-worker-pool.h:20-202,
BatchedThreadedNnet3CudaOnlinePipeline + DynamicBatcher).  Channel slots
have an explicit acquire/release lifecycle.  This is the port's one
streaming decode path: ``OnlineDecoderSession`` (``serving/session.py``)
is a one-channel arena on ``info.device``.

Per-channel device state lives in fixed-shape arenas on ``info.device`` —
beam i32/f32[B,K], LSTM carries f32[B,H] — and idle channels ride along
fully masked (frame mask False ⇒ beam unchanged; LSTM carries are
where-merged back), so N ≤ B streams cost one batched dispatch per tick.

Threads: every method except the ``*_from(snapshot)`` builders runs on one
device thread.  Arena tensors are updated in place, so a snapshot copies
what it captures to the host; result threads touch no CUDA tensor.

Where the logs live follows the search's engine.  The v3 engine
(``TorchBeamSearch`` with ``relax_impl`` topk) keeps each block's logs on
the block's device, in a paged store (``serving/logstore.py``: each
channel row holds pages for the frames it has decoded, so the store's
size is the sum of the live channels' lengths).  ``push`` reserves a
channel's pages for its queued frames, before they are queued: past the
store's limit it raises ``LogStoreFull`` and closes the channel for
input, and the other channels go on.  A tick writes its advanced rows'
frames there in one launch (``ops/traceback.py:store_frames``), and best
paths are walked on the device, one launch for every channel asked at
once (``walk_paths``, ``ops/traceback.py:best_paths_rows``), so a snapshot
carries its channel's path and no logs; a lattice or n-best copies that
channel's logs out of the store (``snapshot(..., logs=True)``).  The v2,
CLG and BigLM searches keep per-channel host logs and the host walk.

Each tick's advanced rows' loglikes (and the host-log engines' logs) are
copied to the host one tick late, as in the JAX arena (tick t's copy runs
while tick t+1 computes), with its slot-reuse fault repaired: ``release``
delivers the pending copy first, so a slot acquired again never inherits
its previous channel's last frames.

With ``use_energy_vad`` each channel keeps its own energy VAD and trailing
silence: ``endpoint_detected(cid)`` applies the session's endpoint rule, and
``init_decoding(cid)`` restarts one channel's search mid-stream (its
feature and AM state kept), delivering the pending logs first, as
``release`` does.

With a ``mesh`` (``parallel/mesh.py``) the arena is dp-sharded: channels
``[i·B/dp, (i+1)·B/dp)`` form dp block ``i``, whose beam rows, LSTM carries
and feature chunk live on the block's device, searched by a replica of the
search there (``parallel/decode.py:shard_search``) through a replica of the
AM (the AM is replicated, as in JAX).  A tick runs the blocks one after
another on the one device thread; each block writes its own replica's
tensors and log store, and logs, paths and snapshots are read back in
channel order.  Without a mesh the arena is one block on ``info.device``.

Beam and logs are handled generically over the three searches (hclg, clg,
biglm-hclg), by the JAX rule: the beam is a NamedTuple of [B, ...] lanes;
every log leaf has the frame axis T first, then ``[stages, B, ...]`` for a
leaf of ndim ≥ 4 and ``[B, ...]`` otherwise (the BigLM ``overflow`` leaf is
[T, B]); the init log follows the same rule without the T axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from asr_decoder_tpu_torch.frontend.pipeline import fbank_many
from asr_decoder_tpu_torch.models.nnet import require_streaming
from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
from asr_decoder_tpu_torch.ops.traceback import HEAD, LENGTH
from asr_decoder_tpu_torch.serving.logstore import LogStore, LogStoreFull
from asr_decoder_tpu_torch.serving.session import (FeatureBuffer,
                                                   OnlineDecoderInfo,
                                                   best_path, empty_path,
                                                   host_log,
                                                   lattice_from_logs,
                                                   merge_logs,
                                                   nbest_from_lattice,
                                                   to_host,
                                                   trailing_silence,
                                                   word_alignment)
from asr_decoder_tpu_torch.utils import profiling


def _pcm(pcm) -> np.ndarray:
    return np.asarray(pcm, np.float32).reshape(1, -1)


def _channel_rows(a: np.ndarray, cid: int, frames: int | None = None
                  ) -> np.ndarray:
    """Channel ``cid``'s rows of a batched log leaf, as a copy: of an init
    log (``frames`` None: [stages, B, ...] for ndim ≥ 3, else [B, ...]), or
    the first ``frames`` frames of a frame log (the same with a leading T
    axis: [T, stages, B, ...] for ndim ≥ 4, else [T, B, ...])."""
    if frames is None:
        rows = a[:, cid:cid + 1] if a.ndim >= 3 else a[cid:cid + 1]
    else:
        rows = (a[:frames, :, cid:cid + 1] if a.ndim >= 4
                else a[:frames, cid:cid + 1])
    return rows.copy()


@dataclass
class _Channel:
    """Host-side per-channel streaming state (the corr-id keyed stream,
    ref: v1-gpu-kaldi-worker-pool.h:74-190)."""
    front: object                  # StreamingFrontend
    featbuf: FeatureBuffer
    skip_phase: int = 0
    pending: list[np.ndarray] = field(default_factory=list)
    pending_frames: int = 0
    eos: bool = False
    drained: bool = False          # eos fully scored
    chunk_logs: list = field(default_factory=list)     # host logs
    loglikes: list[np.ndarray] = field(default_factory=list)
    frames_decoded: int = 0        # stepped (the store's frames of its row)
    vad: object = None             # EnergyVadStream (endpointing) or None
    trailing_sil: int = 0


@dataclass
class _Block:
    """One dp block of the arena: channels ``[lo, hi)`` on ``device``, with
    the search and AM layers there and the block's device state."""
    lo: int
    hi: int
    device: torch.device
    search: object
    layers: list
    beam: tuple                    # the search's beam lanes, [hi - lo, ...]
    beam_init_row: tuple           # lanes [1, ...]: the initial beam
    am_state: list
    store: LogStore | None = None  # v3: the block's log store
    init_log: tuple | None = None  # v3: the init log's row on ``device``


@dataclass
class ChannelSnapshot:
    """Host copy of one channel's result state; safe to read from any
    thread while the arena keeps stepping.  ``path``: the channel's best
    path as the device walk left it (a row of ``ops/traceback.py``'s
    packed output, i32[HEAD + length]) where the arena keeps a log store;
    ``chunk_logs`` then holds the channel's logs only when the snapshot was
    asked for them."""
    beam: tuple                    # the search's beam lanes, numpy [1, K]
    chunk_logs: list
    loglikes: list
    frames_decoded: int
    path: np.ndarray | None = None


class BatchedStreamingDecoder:
    """Up to ``num_channels`` concurrent streams through one batched
    dispatch per tick: ``push(cid, pcm, eos)`` is host frontend work;
    ``step()`` performs one AM forward + search advance over every channel
    with ready frames (the DynamicBatcher::Push/compute cycle).  Pushes to
    many channels at once can share one fbank (``fbank_many``) and their
    snapshots one copy to the host (``copy_beams``)."""

    def __init__(self, info: OnlineDecoderInfo, num_channels: int,
                 mesh=None):
        """``mesh``: an optional ``parallel.mesh.Mesh`` that dp-shards the
        channel arena over its ``dp`` axis (graph and AM replicated), so
        one arena serves streams across every device of the mesh
        (BASELINE config 5; ``num_channels`` must divide by the dp
        size)."""
        from asr_decoder_tpu_torch.parallel.decode import (shard_beam_state,
                                                           shard_search)
        from asr_decoder_tpu_torch.parallel.mesh import (data_sharding,
                                                         replicate_layers)
        require_streaming(info.nnet, "BatchedStreamingDecoder")
        self.info = info
        self.B = num_channels
        self.mesh = mesh
        self._channels: list[_Channel | None] = [None] * num_channels
        self._free = list(range(num_channels))[::-1]
        beam, init_log = info.search.init_state(num_channels)
        if mesh is None:
            rows = [(slice(0, num_channels), info.device)]
            searches, beams = [info.search], [beam]
        else:
            rows = data_sharding(mesh, num_channels)
            searches = shard_search(mesh, info.search)
            beams = shard_beam_state(mesh, beam)
        layers = {}
        self._rows = rows[0][0].stop           # channels a block
        self._blocks: list[_Block] = []
        for (r, dev), search, beam in zip(rows, searches, beams):
            if dev not in layers:
                layers[dev] = replicate_layers(info.am_layers, dev)
            self._blocks.append(_Block(
                r.start, r.stop, dev, search, layers[dev], beam,
                # init rows are identical across the arena: keep row 0
                type(beam)(*(a[:1].clone() for a in beam)),
                [l.init_state(r.stop - r.start, dev) for l in layers[dev]]))
        self._init_log = type(init_log)(*(_channel_rows(a, 0)
                                          for a in host_log(init_log)))
        # the v3 engine keeps its logs on the device (module doc)
        self._stored = (isinstance(info.search, TorchBeamSearch)
                        and info.search.relax_impl == "topk")
        if self._stored:
            S, K = info.search.num_stages, info.search.beam_width
            for blk in self._blocks:
                blk.init_log = type(init_log)(*(
                    torch.from_numpy(a).to(blk.device)
                    for a in self._init_log))
                blk.store = LogStore(blk.hi - blk.lo, S, K, blk.device)
        self._feat_dim = info.am_layers[0].input_dim if info.am_layers else 0
        # the previous tick's copies, on their way to the host:
        # (advanced cids, valid frames, [(host log or None, host loglikes,
        # row -> loglikes row or None)] a block, ready events)
        self._pending: tuple | None = None

    def _block(self, cid: int) -> tuple[_Block, int]:
        """Channel ``cid``'s block and its row there."""
        i, row = divmod(cid, self._rows)
        return self._blocks[i], row

    # -- deferred log delivery ---------------------------------------------
    def _flush_logs(self) -> None:
        """Hand the previous tick's logs to their channels (waits for its
        device→host copy, not for later ticks)."""
        self._deliver(self._wait_logs())

    def _wait_logs(self) -> tuple | None:
        """The previous tick's pending logs, taken once their device→host
        copy has ended (None if there are none)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            for event in pending[3]:
                event.synchronize()
        return pending

    def _deliver(self, pending: tuple | None) -> None:
        """Slice a tick's host copies out to the channels it advanced: their
        loglikes and, where the search keeps host logs, their logs."""
        if pending is None:
            return
        advanced, valid, host, _ = pending
        host = [(None if log is None else [t.numpy() for t in log],
                 ll.numpy(), at) for log, ll, at in host]
        for cid in advanced:
            ch = self._channels[cid]
            v = int(valid[cid])
            i, row = divmod(cid, self._rows)
            log, ll, at = host[i]
            if log is not None:
                ch.chunk_logs.append(type(self._init_log)(
                    *(_channel_rows(a, row, v) for a in log)))
            ch.loglikes.append(ll[row if at is None else at[row], :v].copy())

    # -- channel lifecycle -------------------------------------------------
    @torch.inference_mode()
    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free channels")
        cid = self._free.pop()
        info = self.info
        self._channels[cid] = _Channel(
            front=info.make_frontend(batch=1),
            featbuf=FeatureBuffer(info.left, info.right, info.splice_offsets),
            vad=info.make_vad())
        self._reset_beam_row(cid)
        blk, row = self._block(cid)
        for st in blk.am_state:
            for v in st.values():
                v[row] = 0.0
        return cid

    def _reset_beam_row(self, cid: int) -> None:
        """Channel ``cid``'s row of every beam lane back to the initial
        beam (each search's beam is a NamedTuple of [B, ...] lanes)."""
        blk, row = self._block(cid)
        for arena, init in zip(blk.beam, blk.beam_init_row):
            arena[row] = init[0]

    def release(self, cid: int) -> None:
        if self._channels[cid] is None:
            raise ValueError(f"channel {cid} is not acquired")
        # deliver a pending tick's logs while the slot still names this
        # channel: once released, the slot may be acquired again
        self._flush_logs()
        self._channels[cid] = None
        self._free.append(cid)
        blk, row = self._block(cid)
        if blk.store is not None:
            blk.store.clear(row)

    @torch.inference_mode()
    def init_decoding(self, cid: int) -> None:
        """Restart channel ``cid``'s search only, keeping its feature and
        AM streaming state — the mid-stream endpoint restart (ref
        InitDecoding(frame_offset), kaldi-online-nnet3-my-decoder.h
        :301-324).  The pending tick's logs are delivered first, so they
        are dropped with the finished segment's."""
        self._flush_logs()
        ch = self._channels[cid]
        if ch is None:
            raise ValueError(f"channel {cid} is not acquired")
        self._reset_beam_row(cid)
        ch.chunk_logs = []
        ch.loglikes = []
        ch.frames_decoded = 0
        blk, row = self._block(cid)
        if blk.store is not None:
            # the frames still queued start the new search at page 0
            blk.store.clear(row)
            blk.store.reserve(row, ch.pending_frames)

    def endpoint_detected(self, cid: int) -> bool:
        """The session's endpoint rule over channel ``cid`` (ref
        EndpointDetected, kaldi-online-nnet3-my-decoder.h:344); needs
        use_energy_vad."""
        self._flush_logs()
        ch = self._channels[cid]
        return ch is not None and self.info.endpoint(ch.frames_decoded,
                                                     ch.trailing_sil)

    def frames_decoded(self, cid: int) -> int:
        """Frames channel ``cid`` has decoded since its search started."""
        self._flush_logs()
        return self._channels[cid].frames_decoded

    # -- streaming input (host frontend, ref DynamicBatcher::Push) ---------
    def _open(self, cid: int) -> _Channel:
        ch = self._channels[cid]
        if ch is None or ch.eos:
            raise ValueError(f"channel {cid} is not open for input")
        return ch

    def fbank_many(self, pushes: list[tuple[int, np.ndarray, bool]]
                   ) -> list[np.ndarray]:
        """The fbank frames of every push ``(cid, pcm, eos)``, one channel
        each, computed at once (``frontend/pipeline.py:fbank_many``); hand
        each to its ``push(cid, pcm, eos, fbank=...)``, in this order."""
        fronts = [self._open(cid).front for cid, _, _ in pushes]
        return fbank_many(fronts, [_pcm(pcm) for _, pcm, _ in pushes],
                          [eos for _, _, eos in pushes])

    def push(self, cid: int, pcm: np.ndarray, eos: bool = False,
             fbank: np.ndarray | None = None) -> None:
        """Channel ``cid``'s next chunk of PCM; ``fbank``: its fbank frames
        as ``fbank_many`` computed them, in place of the channel's own
        fbank of ``pcm``.  Raises ``LogStoreFull`` where the log store
        cannot hold the channel's frames (module doc)."""
        ch = self._open(cid)
        info = self.info
        pcm = _pcm(pcm)
        ch.trailing_sil = trailing_silence(ch.vad, pcm, eos, ch.trailing_sil)
        feats = (ch.front.accept(pcm, end=eos) if fbank is None
                 else ch.front.finish(pcm, fbank, end=eos))[0]
        spliced = ch.featbuf.accept(feats, end=eos)
        # plain skip drops frames here; skip_copy subsamples inside
        # am_forward — the same split as the JAX session
        skip = info.am_config.skip
        if skip and spliced.shape[0] and not info.am_config.skip_copy:
            sel = (np.arange(spliced.shape[0]) + ch.skip_phase) \
                % (skip + 1) == 0
            ch.skip_phase = (ch.skip_phase + spliced.shape[0]) % (skip + 1)
            spliced = spliced[sel]
        if spliced.shape[0]:
            blk, row = self._block(cid)
            if blk.store is not None:
                try:
                    blk.store.reserve(row, ch.frames_decoded
                                      + ch.pending_frames
                                      + spliced.shape[0])
                except LogStoreFull:
                    # its frames are lost: the channel takes no more input
                    ch.eos = ch.drained = True
                    raise
            ch.pending.append(spliced)
            ch.pending_frames += spliced.shape[0]
        if eos:
            ch.eos = True
            if ch.pending_frames == 0:
                ch.drained = True

    def ready(self, cid: int) -> bool:
        """Channel has a full chunk (or an EOS flush) waiting."""
        ch = self._channels[cid]
        if ch is None or ch.drained:
            return False
        C = self.info.config.chunk_frames
        return ch.pending_frames >= C or (ch.eos and ch.pending_frames > 0)

    def pending_work(self) -> bool:
        return any(self.ready(c) for c in range(self.B))

    # -- the batched device step -------------------------------------------
    @torch.inference_mode()
    def step(self) -> list[int]:
        """One batched AM+search dispatch over every ready channel.
        Returns the channel ids that advanced."""
        info = self.info
        C = info.config.chunk_frames
        with profiling.span("tick/pack"):
            feats = np.zeros((self.B, C, self._feat_dim), np.float32)
            valid = np.zeros(self.B, np.int32)
            offs = np.zeros(self.B, np.int64)   # frames before this tick
            advanced: list[int] = []
            for cid in range(self.B):
                if not self.ready(cid):
                    continue
                ch = self._channels[cid]
                buf = np.concatenate(ch.pending, axis=0)
                take, rest = buf[:C], buf[C:]
                ch.pending = [rest] if rest.shape[0] else []
                ch.pending_frames = rest.shape[0]
                v = take.shape[0]
                if v < C:
                    take = np.concatenate(
                        [take, np.repeat(take[-1:], C - v, axis=0)], axis=0)
                feats[cid] = take
                valid[cid] = v
                offs[cid] = ch.frames_decoded
                ch.frames_decoded += v
                advanced.append(cid)
                if ch.eos and ch.pending_frames == 0:
                    ch.drained = True
        if not advanced:
            return []
        host, ready = [], []
        with profiling.span("tick/launch"):
            for blk in self._blocks:
                rows = slice(blk.lo, blk.hi)
                loglikes, new_am, mask = info.score(
                    torch.from_numpy(feats[rows]).to(blk.device),
                    blk.am_state, valid[rows], blk.layers)
                # idle channels keep their LSTM carries bit-exactly
                active = torch.from_numpy(valid[rows] > 0).to(
                    blk.device)[:, None]
                blk.am_state = [{k: torch.where(active, n[k], o[k])
                                 for k in o}
                                for n, o in zip(new_am, blk.am_state)]
                blk.beam, log = blk.search.advance(blk.beam, loglikes, mask)
                if blk.store is None:
                    host.append(([t.to("cpu", non_blocking=True)
                                  for t in log],
                                 loglikes.to("cpu", non_blocking=True), None))
                else:
                    # the advanced rows' frames into the store, their
                    # loglikes packed: the only copy to the host
                    mine = np.flatnonzero(valid[rows])
                    packed = blk.store.write(log, loglikes, mine,
                                             offs[rows][mine],
                                             valid[rows][mine])
                    at = np.zeros(blk.hi - blk.lo, np.int64)
                    at[mine] = np.arange(len(mine))
                    host.append((None, packed.to("cpu", non_blocking=True),
                                 at))
                if blk.device.type == "cuda":
                    ready.append(torch.cuda.Event())
                    ready[-1].record(torch.cuda.current_stream(blk.device))
        # the previous tick's copies were queued before this tick's work, so
        # waiting for them here does not wait for this tick
        with profiling.span("tick/wait"):
            pending = self._wait_logs()
        with profiling.span("tick/deliver"):
            self._deliver(pending)
        self._pending = (advanced, valid, host, ready)
        return advanced

    def drain(self) -> None:
        """Run steps until no channel has ready work."""
        while self.pending_work():
            self.step()
        self._flush_logs()

    # -- results -------------------------------------------------------------
    #
    # ``snapshot(cid)`` runs on the device thread (it flushes and copies the
    # channel's beam row to the host, and where the arena keeps a log store
    # walks its best path there); the ``*_from(snap)`` builders —
    # traceback, word alignment, lattice, n-best — read only that host copy
    # and may run on other threads while the arena keeps stepping.  The
    # ``cid`` forms take the snapshot first, so they run on the device
    # thread.
    def snapshot(self, cid: int, beam: tuple | None = None,
                 path: np.ndarray | None = None, logs: bool = False
                 ) -> ChannelSnapshot:
        """``beam`` and ``path``: the channel's beam rows as ``copy_beams``
        copied them and its path as ``walk_paths`` walked it since the last
        ``step``, in place of a copy and a walk of its own.  ``logs``: copy
        the channel's logs out of the log store too (a lattice or n-best
        needs them; host logs are always there)."""
        self._flush_logs()
        ch = self._channels[cid]
        blk, row = self._block(cid)
        if beam is None:
            beam = type(blk.beam)(*(to_host(a[row:row + 1])
                                    for a in blk.beam))
        chunk_logs = list(ch.chunk_logs)
        if blk.store is not None:
            if path is None:
                path, = self.walk_paths([cid])
            if logs and ch.frames_decoded:
                chunk_logs = [blk.store.frames(row, ch.frames_decoded)]
        return ChannelSnapshot(beam=beam, chunk_logs=chunk_logs,
                               loglikes=list(ch.loglikes),
                               frames_decoded=ch.frames_decoded, path=path)

    @torch.inference_mode()
    def walk_paths(self, cids: list[int]) -> list[np.ndarray | None]:
        """The best paths so far of channels ``cids``, for their
        ``snapshot(cid, beam, path)``: per block one launch of the walk over
        its log store (``ops/traceback.py:best_paths_rows``, each channel
        over its own frames), then one copy of the paths to the host.  Each
        is its row of the walk's packed output (a copy, cut to its
        length); None for each where the search keeps host logs."""
        if not self._stored:
            return [None] * len(cids)
        by_block: dict[int, list[int]] = {}
        for cid in cids:
            by_block.setdefault(cid // self._rows, []).append(cid)
        host, ready = {}, []
        for i, mine in by_block.items():
            blk = self._blocks[i]
            out = blk.store.walk(
                self.info.search.walk_tables_on(blk.device), blk.beam,
                blk.init_log, [c - blk.lo for c in mine],
                [self._channels[c].frames_decoded for c in mine])
            if blk.device.type == "cuda":
                host[i] = torch.empty(out.shape, dtype=out.dtype,
                                      pin_memory=True)
                host[i].copy_(out, non_blocking=True)
                ready.append(torch.cuda.Event())
                ready[-1].record(torch.cuda.current_stream(blk.device))
            else:
                host[i] = out
        for event in ready:
            event.synchronize()
        paths = {}
        for i, mine in by_block.items():
            rows = host[i].numpy()
            for cid, row in zip(mine, rows):
                paths[cid] = row[:HEAD + max(int(row[LENGTH]), 0)].copy()
        return [paths[cid] for cid in cids]

    @torch.inference_mode()
    def copy_beams(self, cids: list[int]) -> list[tuple]:
        """The beam rows of channels ``cids`` (lanes, numpy [1, ...]), for
        their ``snapshot(cid, beam)``: the logs flushed, then per block one
        copy to the host a lane of its rows from the first to the last of
        those channels (a plain copy: a gather of the rows would launch a
        kernel as well).  The host copies are the callers' own: no later
        call writes them."""
        self._flush_logs()
        rows: dict[int, list[int]] = {}
        for cid in cids:
            i, row = divmod(cid, self._rows)
            rows.setdefault(i, []).append(row)
        host, ready = {}, []
        for i, r in rows.items():
            blk = self._blocks[i]
            lo, hi = min(r), max(r) + 1
            host[i] = (lo, [a[lo:hi].to("cpu", non_blocking=True,
                                        copy=True) for a in blk.beam])
            if blk.device.type == "cuda":
                ready.append(torch.cuda.Event())
                ready[-1].record(torch.cuda.current_stream(blk.device))
        for event in ready:
            event.synchronize()
        out = []
        for cid in cids:
            i, row = divmod(cid, self._rows)
            lo, lanes = host[i]
            k = row - lo
            out.append(type(self._blocks[i].beam)(
                *(a[k:k + 1].numpy() for a in lanes)))
        return out

    def get_best_path_from(self, snap: ChannelSnapshot) -> dict:
        """The channel's best path so far: from the path the device walk
        left in the snapshot (the span ``path/card``: label lookups only),
        else walked over its host logs (``path/host``)."""
        if snap.path is None:
            with profiling.span("path/host"):
                return best_path(self.info, snap.beam, self._init_log,
                                 snap.chunk_logs)
        with profiling.span("path/card"):
            if not snap.frames_decoded:
                return empty_path()
            return self.info.search.traceback(None, None, snap.path[None],
                                              self.info.fst)[0]

    def get_best_path(self, cid: int) -> dict:
        return self.get_best_path_from(self.snapshot(cid))

    def get_best_path_txt(self, cid: int) -> str:
        res = self.get_best_path(cid)
        return " ".join(self.info.words.words(res.get("words", [])))

    def get_word_alignment_from(self, snap: ChannelSnapshot,
                                frame_offset: int = 0
                                ) -> list[tuple[str, float, float]]:
        """AlignTime payload [(word, begin_s, end_s)] of the channel's best
        path, ``frame_offset`` decoded frames in; raises ``RuntimeError``
        for a clg graph, which has no arc-labelled ``fst``."""
        return word_alignment(self.info, self.get_best_path_from(snap),
                              frame_offset)

    def get_word_alignment(self, cid: int, frame_offset: int = 0
                           ) -> list[tuple[str, float, float]]:
        return self.get_word_alignment_from(self.snapshot(cid), frame_offset)

    def get_lattice_from(self, snap: ChannelSnapshot,
                         determinize: bool = True):
        """The lattice of a snapshot that holds the channel's logs
        (``snapshot(cid, logs=True)`` where the arena keeps a log store),
        or None for a channel with no frames."""
        logs = merge_logs(snap.chunk_logs)
        if logs is None:
            if snap.frames_decoded:
                raise ValueError("the snapshot holds no logs: take it with "
                                 "snapshot(cid, logs=True)")
            return None
        lls = np.concatenate(snap.loglikes, axis=0)[None]
        return lattice_from_logs(self.info, self._init_log, logs, lls,
                                 determinize)

    def get_lattice(self, cid: int, determinize: bool = True):
        """The channel's lattice (determinized unless asked not to), or
        None for a channel with no frames."""
        return self.get_lattice_from(self.snapshot(cid, logs=True),
                                     determinize)

    def get_nbest_from(self, snap: ChannelSnapshot, n: int) -> list[dict]:
        return nbest_from_lattice(
            self.info, self.get_lattice_from(snap, determinize=True), n)

    def get_nbest(self, cid: int, n: int) -> list[dict]:
        return self.get_nbest_from(self.snapshot(cid, logs=True), n)
