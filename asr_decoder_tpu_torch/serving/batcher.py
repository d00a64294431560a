"""Batched multi-stream decoding: channel arena + dynamic batcher.

Port of ``asr_decoder_tpu/serving/batcher.py``: many streaming channels
packed into one AM forward + one search advance per tick (ref:
src/gpu-asr/v1-gpu-kaldi-worker-pool.h:20-202,
BatchedThreadedNnet3CudaOnlinePipeline + DynamicBatcher).  Channel slots
have an explicit acquire/release lifecycle.

Per-channel device state lives in fixed-shape arenas on ``info.device`` —
beam i32/f32[B,K], LSTM carries f32[B,H] — and idle channels ride along
fully masked (frame mask False ⇒ beam unchanged; LSTM carries are
where-merged back), so N ≤ B streams cost one batched dispatch per tick.

Threads: every method except the ``*_from(snapshot)`` builders runs on one
device thread.  Arena tensors are updated in place, so a snapshot copies
what it captures to the host; result threads touch no CUDA tensor.

The one-tick deferred log copy of the JAX arena is kept (tick t's logs
stream to the host while tick t+1 computes), with its slot-reuse fault
repaired: ``release`` delivers the pending logs first, so a slot acquired
again never inherits its previous channel's last logs.

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
tensors, and logs and snapshots are read back in channel order.  Without a
mesh the arena is one block on ``info.device``.

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

from asr_decoder_tpu_torch.models.nnet import require_streaming
from asr_decoder_tpu_torch.serving.session import (FeatureBuffer,
                                                   OnlineDecoderInfo,
                                                   best_path, host_log,
                                                   lattice_from_logs,
                                                   merge_logs,
                                                   nbest_from_lattice,
                                                   to_host,
                                                   trailing_silence,
                                                   word_alignment)
from asr_decoder_tpu_torch.utils import profiling


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
    frames_decoded: int = 0
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


@dataclass
class ChannelSnapshot:
    """Host copy of one channel's result state; safe to read from any
    thread while the arena keeps stepping."""
    beam: tuple                    # the search's beam lanes, numpy [1, K]
    chunk_logs: list
    loglikes: list
    frames_decoded: int


class BatchedStreamingDecoder:
    """Up to ``num_channels`` concurrent streams through one batched
    dispatch per tick: ``push(cid, pcm, eos)`` is host frontend work;
    ``step()`` performs one AM forward + search advance over every channel
    with ready frames (the DynamicBatcher::Push/compute cycle)."""

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
        self._feat_dim = info.am_layers[0].input_dim if info.am_layers else 0
        # the previous tick's logs, on their way to the host:
        # (advanced cids, valid frames, [(host log, host loglikes)] a
        # block, ready events)
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
        """Slice a tick's host logs out to the channels it advanced."""
        if pending is None:
            return
        advanced, valid, host, _ = pending
        host = [([t.numpy() for t in log], ll.numpy()) for log, ll in host]
        for cid in advanced:
            ch = self._channels[cid]
            v = int(valid[cid])
            i, row = divmod(cid, self._rows)
            log, ll = host[i]
            ch.chunk_logs.append(type(self._init_log)(
                *(_channel_rows(a, row, v) for a in log)))
            ch.loglikes.append(ll[row, :v].copy())
            ch.frames_decoded += v

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

    def endpoint_detected(self, cid: int) -> bool:
        """The session's endpoint rule over channel ``cid`` (ref
        EndpointDetected, kaldi-online-nnet3-my-decoder.h:344); needs
        use_energy_vad."""
        self._flush_logs()
        ch = self._channels[cid]
        return ch is not None and self.info.endpoint(ch.frames_decoded,
                                                     ch.trailing_sil)

    # -- streaming input (host frontend, ref DynamicBatcher::Push) ---------
    def push(self, cid: int, pcm: np.ndarray, eos: bool = False) -> None:
        ch = self._channels[cid]
        if ch is None or ch.eos:
            raise ValueError(f"channel {cid} is not open for input")
        info = self.info
        pcm = np.asarray(pcm, np.float32).reshape(1, -1)
        ch.trailing_sil = trailing_silence(ch.vad, pcm, eos, ch.trailing_sil)
        feats = ch.front.accept(pcm, end=eos)[0]
        spliced = ch.featbuf.accept(feats, end=eos)
        # plain skip drops frames here; skip_copy subsamples inside
        # am_forward — the same split as session.py
        skip = info.am_config.skip
        if skip and spliced.shape[0] and not info.am_config.skip_copy:
            sel = (np.arange(spliced.shape[0]) + ch.skip_phase) \
                % (skip + 1) == 0
            ch.skip_phase = (ch.skip_phase + spliced.shape[0]) % (skip + 1)
            spliced = spliced[sel]
        if spliced.shape[0]:
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
                host.append(([t.to("cpu", non_blocking=True) for t in log],
                             loglikes.to("cpu", non_blocking=True)))
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
    # channel's beam row to the host); the ``*_from(snap)`` builders —
    # traceback, word alignment, lattice, n-best — read only that host copy
    # and may run on other threads while the arena keeps stepping.  The
    # ``cid`` forms take the snapshot first, so they run on the device
    # thread.
    def snapshot(self, cid: int) -> ChannelSnapshot:
        self._flush_logs()
        ch = self._channels[cid]
        blk, row = self._block(cid)
        return ChannelSnapshot(
            beam=type(blk.beam)(*(to_host(a[row:row + 1])
                                  for a in blk.beam)),
            chunk_logs=list(ch.chunk_logs),
            loglikes=list(ch.loglikes),
            frames_decoded=ch.frames_decoded)

    def get_best_path_from(self, snap: ChannelSnapshot) -> dict:
        return best_path(self.info, snap.beam, self._init_log,
                         snap.chunk_logs)

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
        logs = merge_logs(snap.chunk_logs)
        if logs is None:
            return None
        lls = np.concatenate(snap.loglikes, axis=0)[None]
        return lattice_from_logs(self.info, self._init_log, logs, lls,
                                 determinize)

    def get_lattice(self, cid: int, determinize: bool = True):
        """The channel's lattice (determinized unless asked not to), or
        None for a channel with no frames."""
        return self.get_lattice_from(self.snapshot(cid), determinize)

    def get_nbest_from(self, snap: ChannelSnapshot, n: int) -> list[dict]:
        return nbest_from_lattice(
            self.info, self.get_lattice_from(snap, determinize=True), n)

    def get_nbest(self, cid: int, n: int) -> list[dict]:
        return self.get_nbest_from(self.snapshot(cid), n)
