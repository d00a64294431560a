"""Streaming ASR TCP service over a batched channel arena, in PyTorch.

Port of ``asr_decoder_tpu/serving/server.py`` (ref: the v2 service stack —
src/service2/socket-class.h:19-70, thread-pool.h:16-66, the per-connection
task loop of src/v2-asr/v2-asr-task.h:57-327 with 3-strike receive timeout
and zero-chunk EOS repair, RTF accounting of service2/thread-info.h:10-23 —
and the GPU dynamic batcher of src/gpu-asr/v1-gpu-kaldi-worker-pool.h
:20-202).  It speaks the wire protocol of the shared
``asr_decoder_tpu/serving/protocol.py``, so the JAX package's clients talk
to it unchanged.

Connections are asyncio coroutines that push PCM into their channel of one
``BatchedStreamingDecoder``; a device-loop coroutine ticks the arena, each
tick one batched AM+search dispatch over every channel with a ready chunk.
Every arena call runs on a one-thread executor (the arena is
single-writer); result building (traceback, lattice, n-best) runs on a
result pool over host snapshots.

With ``use_energy_vad``, a reply whose push ends in an endpoint (trailing
silence, ``BatchedStreamingDecoder.endpoint_detected``) is a ``MIDDLEEND``
final of the segment: its words and alignment are folded into the
connection's prefix, later replies carry the prefix before their own
segment, the segment's alignment is offset by the frames decoded before it,
and the channel's search restarts (``init_decoding``) while its features
and AM state stream on (ref: MIDDLEEND + InitDecoding(frame_offset) and the
v1 worker's _best_result accumulation, kaldi-v1-asr-online.h:795-840).
"""

from __future__ import annotations

import asyncio
import itertools
import socket as socketlib
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import suppress
from dataclasses import dataclass

from asr_decoder_tpu_torch.serving.protocol import (C2SPackage, EndFlag,
                                                    NbestResult, S2CPackage,
                                                    frame_s2c, read_c2s)
from asr_decoder_tpu_torch.utils import profiling
from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.utils.logging import get_logger
from asr_decoder_tpu_torch.serving.batcher import (BatchedStreamingDecoder,
                                                   ChannelSnapshot)
from asr_decoder_tpu_torch.serving.session import (OnlineDecoderInfo,
                                                   word_alignment)

LOG = get_logger("serving")


@dataclass
class SocketConfig:
    """ref: SocketConf (service2/socket-class.h:19-67)."""
    ip: str = flag("127.0.0.1", "Listen address")
    port: int = flag(8100, "Listen port")
    num_channels: int = flag(
        32, "Streaming channels in the batched device arena (admission "
            "limit; ref --num-channels, gpu-asr/conf/config.txt)")
    rec_timeout: int = flag(30, "Per-package receive timeout (s)")
    timeout_strikes: int = flag(
        3, "Consecutive receive timeouts before disconnect "
           "(ref v1-asr-task.h:83-92)")
    advertise_rescore: bool = flag(
        False, "Set do_rescore on final replies that carry a lattice, "
               "telling clients to forward it to the post-processing "
               "service (ref S2C do_rescore)")
    result_workers: int = flag(
        2, "Threads for heavy result building (traceback/lattice/"
           "determinize/n-best) so one client's expensive final never "
           "stalls the device loop")
    keepalive: bool = flag(True, "Enable TCP keepalive on connections")
    keep_idle: int = flag(120, "TCP_KEEPIDLE seconds")
    keep_interval: int = flag(10, "TCP_KEEPINTVL seconds")
    keep_count: int = flag(3, "TCP_KEEPCNT probes")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


@dataclass
class UttStats:
    """Per-utterance timing (ref: ThreadTimeInfo semantics): the audio
    pushed, and the server's time on its packets (their ``request`` spans:
    each from the packet's read to its reply's write and, after the last,
    the channel's release)."""
    wav_seconds: float = 0.0
    work_seconds: float = 0.0

    @property
    def rtf(self) -> float:
        return self.work_seconds / self.wav_seconds if self.wav_seconds else 0.0


class AsrServer:
    def __init__(self, info: OnlineDecoderInfo,
                 socket_config: SocketConfig | None = None):
        self.info = info
        self.config = socket_config or SocketConfig()
        # single-writer executor: every arena call (host frontend + device
        # dispatch) runs here; batching happens inside the dispatch
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="device")
        self._result_pool = ThreadPoolExecutor(
            max_workers=max(1, self.config.result_workers),
            thread_name_prefix="results")
        self._batcher = BatchedStreamingDecoder(info,
                                                self.config.num_channels)
        self._chan_sem = asyncio.Semaphore(self.config.num_channels)
        self._work = asyncio.Event()
        self._chan_events: dict[int, asyncio.Event] = {}
        self._server: asyncio.AbstractServer | None = None
        self._device_task: asyncio.Task | None = None
        self.total = UttStats()
        self.dispatches = 0       # batched device steps
        self.chunks_decoded = 0   # channel-chunks consumed across dispatches
        self._connections = itertools.count()   # serials of the requests' req

    async def _run(self, name: str, fn, *args, req=None):
        """``fn(*args)`` on the device thread, recorded as the span
        ``name`` (``device/<call>``) after a ``device/queue`` span from its
        submit to its start."""
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, _timed, "device/queue", name, req,
            time.perf_counter(), fn, args)

    async def _run_result(self, fn, *args, req=None):
        return await asyncio.get_running_loop().run_in_executor(
            self._result_pool, _timed, "results/queue", "results/build", req,
            time.perf_counter(), fn, args)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.config.ip, self.config.port)
        self._device_task = asyncio.ensure_future(self._device_loop())
        addr = self._server.sockets[0].getsockname()[:2]
        LOG.info("listening on %s:%d (%d channels, %s)", *addr,
                 self.config.num_channels, self.info.device)
        return addr

    async def stop(self) -> None:
        if self._device_task is not None:
            self._device_task.cancel()
            with suppress(asyncio.CancelledError):
                await self._device_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=True)
        self._result_pool.shutdown(wait=True)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- the batched device loop (ref DynamicBatcher compute cycle) --------
    async def _device_loop(self) -> None:
        """Tick the arena whenever any connection has pushed work: each
        step() is one batched dispatch over every ready channel."""
        while True:
            await self._work.wait()
            self._work.clear()
            while True:
                advanced = await self._run("device/step", self._batcher.step)
                if not advanced:
                    break
                self.dispatches += 1
                self.chunks_decoded += len(advanced)
                for cid in advanced:
                    ev = self._chan_events.get(cid)
                    if ev is not None:
                        ev.set()

    async def _pump(self, cid: int, req=None) -> None:
        """Block until the device loop has consumed every ready chunk of
        this channel (clear-before-check: step() completes on the same
        1-thread executor as ready(), so a set() between our check and
        wait() is always observed)."""
        ev = self._chan_events[cid]
        while True:
            ev.clear()
            if not await self._run("device/ready", self._batcher.ready, cid,
                                   req=req):
                return
            self._work.set()
            await ev.wait()

    # -- per-connection task loop (ref: v2-asr-task.h:57-327) --------------
    def _tune_socket(self, writer: asyncio.StreamWriter) -> None:
        """TCP keepalive tuning (ref socket-class.h:24-31)."""
        sock = writer.get_extra_info("socket")
        if sock is None or not self.config.keepalive:
            return
        with suppress(OSError):
            sock.setsockopt(socketlib.SOL_SOCKET,
                            socketlib.SO_KEEPALIVE, 1)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPIDLE, self.config.keep_idle)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPINTVL,
                            self.config.keep_interval)
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_KEEPCNT, self.config.keep_count)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._tune_socket(writer)
        conn = next(self._connections)
        cid: int | None = None
        stats = UttStats()
        sr = 16000
        strikes = 0
        # text/align of the finished segments, prepended to later replies
        prefix_words: list[int] = []
        prefix_align: list = []
        prefix_frames = 0
        try:
            while True:
                try:
                    pkg = await asyncio.wait_for(
                        read_c2s(reader), self.config.rec_timeout)
                    strikes = 0
                except asyncio.TimeoutError:
                    # 3-strike disconnect (ref v1-asr-task.h:83-92)
                    strikes += 1
                    if strikes >= self.config.timeout_strikes:
                        LOG.warning("receive timeout ×%d, disconnecting",
                                    strikes)
                        break
                    continue
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if cid is not None and not pkg.data and not pkg.end_flag:
                    # zero-length mid-stream chunk: forced-EOS repair
                    # (ref v1-asr-task.h:105-110)
                    pkg.end_flag = True
                req = (conn, pkg.n)
                with profiling.span("request", req) as request:
                    if cid is None or pkg.audio_head:
                        if cid is not None:
                            await self._close_channel(cid, req)
                            cid = None
                        with profiling.span("admission"):
                            await self._chan_sem.acquire()
                        cid = await self._run("device/acquire",
                                              self._batcher.acquire, req=req)
                        self._chan_events[cid] = asyncio.Event()
                        stats = UttStats()
                        sr = pkg.sample_rate.hz
                        prefix_words, prefix_align, prefix_frames = [], [], 0
                    samples = pkg.samples()
                    stats.wav_seconds += len(samples) / sr
                    await self._run("device/push", self._batcher.push, cid,
                                    samples, bool(pkg.end_flag), req=req)
                    with profiling.span("pump"):
                        await self._pump(cid, req)
                    endpoint = (not pkg.end_flag and await self._run(
                        "device/endpoint_detected",
                        self._batcher.endpoint_detected, cid, req=req))
                    # snapshot under the device writer, build results off it
                    snap = await self._run("device/snapshot",
                                           self._batcher.snapshot, cid,
                                           req=req)
                    reply, seg_words, seg_align = await self._run_result(
                        self._results, snap, pkg,
                        bool(pkg.end_flag) or endpoint, prefix_words,
                        prefix_align, prefix_frames, req=req)
                    with profiling.span("write"):
                        writer.write(frame_s2c(reply))
                        await writer.drain()
                    if pkg.end_flag:
                        await self._close_channel(cid, req)
                        cid = None
                    elif endpoint:
                        # mid-stream endpoint: fold the finished segment
                        # into the prefix, restart the search, keep the
                        # stream
                        prefix_words = prefix_words + seg_words
                        prefix_align = prefix_align + seg_align
                        prefix_frames += snap.frames_decoded
                        await self._run("device/init_decoding",
                                        self._batcher.init_decoding, cid,
                                        req=req)
                stats.work_seconds += request.seconds
                if pkg.end_flag:
                    LOG.info("utt done: wav=%.2fs work=%.2fs rtf=%.4f",
                             stats.wav_seconds, stats.work_seconds,
                             stats.rtf)
                    self.total.wav_seconds += stats.wav_seconds
                    self.total.work_seconds += stats.work_seconds
        finally:
            if cid is not None:
                await self._close_channel(cid)
            writer.close()
            with suppress(ConnectionError):
                await writer.wait_closed()

    async def _close_channel(self, cid: int, req=None) -> None:
        await self._run("device/release", self._batcher.release, cid,
                        req=req)
        self._chan_events.pop(cid, None)
        self._chan_sem.release()

    def _results(self, snap: ChannelSnapshot, pkg: C2SPackage, final: bool,
                 prefix_words: list[int], prefix_align: list,
                 prefix_frames: int) -> tuple[S2CPackage, list[int], list]:
        """Build the S2C reply from a channel snapshot (ref:
        v2-asr-task.h SendDataAndGetResult); runs on the result pool and
        reads only the snapshot and read-only model state.  ``final`` is
        the end of the stream or of an endpointed segment.  Returns (reply,
        segment words, segment alignment) for the caller to fold into the
        prefix at an endpoint."""
        end = (EndFlag.END if pkg.end_flag
               else EndFlag.MIDDLEEND if final else EndFlag.NOEND)
        reply = S2CPackage(end_flag=end)
        words = self.info.words
        prefix_text = " ".join(words.words(prefix_words))

        def with_prefix(text: str) -> str:
            return f"{prefix_text} {text}".strip() if prefix_text else text

        with profiling.span("result/traceback"):
            best = self._batcher.get_best_path_from(snap)
        seg_words = list(best.get("words", []))
        if final and pkg.nbest > 1:
            for r in self._batcher.get_nbest_from(snap, pkg.nbest):
                reply.results.append(NbestResult(
                    with_prefix(r["text"]), r["graph_cost"], r["am_cost"],
                    prefix_words + r["words"]))
        if not reply.results:
            reply.results.append(NbestResult(
                with_prefix(" ".join(words.words(seg_words))),
                best.get("cost", 0.0), 0.0, prefix_words + seg_words))
        if best.get("overflowed"):
            # BigLM lm_lanes overflow dropped word candidates of this
            # utterance: never silent (the reference never drops, ref
            # online-decoder-mempool-base-biglm.h:316-402) — warn the
            # client in-band and the operator in the log
            reply.warn = True
            LOG.warning("biglm lm_lanes overflow on this utterance: "
                        "results may be inexact (raise lm_lanes)")
        # per-word time spans (ref AlignTime, net-data-package.h:210) are
        # computed at every reply that can fold a segment into the prefix,
        # so a client asking for them only on its last chunk still gets
        # every segment's; a clg graph has no arc-labelled fst, so its
        # replies carry none
        seg_align: list = []
        if self.info.fst is not None:
            with profiling.span("result/align"):
                seg_align = word_alignment(self.info, best, prefix_frames)
        if pkg.ali_info and self.info.fst is not None:
            reply.align = prefix_align + seg_align
            reply.ali_info = True
        if pkg.score_info:
            # (graph, acoustic) costs ride every NbestResult already
            reply.score_info = True
        if final and pkg.lattice:
            lat = self._batcher.get_lattice_from(snap, determinize=True)
            if lat is not None:
                reply.lattice = lat.to_bytes()
                reply.do_rescore = self.config.advertise_rescore
        return reply, seg_words, seg_align


def _timed(queue: str, name: str, req, submitted: float, fn, args):
    """``fn(*args)`` on an executor's thread: the span ``queue`` from
    ``submitted`` to now, then ``fn`` inside the span ``name``."""
    profiling.record(queue, submitted, time.perf_counter(), req)
    with profiling.span(name, req):
        return fn(*args)


def run_server(info: OnlineDecoderInfo,
               socket_config: SocketConfig | None = None) -> None:
    asyncio.run(AsrServer(info, socket_config).serve_forever())
