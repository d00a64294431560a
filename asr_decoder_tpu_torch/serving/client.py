"""Streaming ASR clients.

Capability parity with the reference clients — the chunked streaming client
(ref: src/service2bin/asr-client.cc), the C-ABI client API surface
(ref: src/client/py-client/asr-client-api.h:10-24 — TcpConnect / SendPack /
SendLastPack / GetResult — and its ctypes wrapper
src/client/py-client/client.py:14-60), and the multi-stream load generator
(ref: src/clientbin/thread-client.cc).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from asr_decoder_tpu_torch.serving.protocol import (C2SPackage, DType, EndFlag,
                                                    S2CPackage, read_s2c)


class AsyncAsrClient:
    """One streaming connection (ref: asr-client.cc chunk loop)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8100):
        self.host, self.port = host, port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._n = 0

    async def connect(self) -> None:
        """ref: TcpConnect (asr-client-api.h:12)."""
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._n = 0

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except ConnectionError:
                pass

    async def send_chunk(self, samples: np.ndarray, *, end: bool = False,
                         nbest: int = 0, lattice: bool = False,
                         ali_info: bool = False,
                         score_info: bool = False) -> S2CPackage:
        """Send one PCM chunk, await the per-chunk reply
        (ref: SendPack / SendLastPack, asr-client-api.h:14-18).
        ``ali_info`` requests per-word time spans in the reply (the
        AlignTime payload, ref net-data-package.h:210 — available on the
        parsed reply as ``.align``)."""
        assert self._writer is not None and self._reader is not None
        pkg = C2SPackage.from_samples(
            samples, dtype=DType.SHORT, audio_head=(self._n == 0),
            end_flag=end, nbest=nbest, lattice=lattice, ali_info=ali_info,
            score_info=score_info, n=self._n)
        self._n += 1
        self._writer.write(pkg.pack())
        await self._writer.drain()
        return await read_s2c(self._reader)

    async def decode_utterance(self, samples: np.ndarray,
                               chunk_samples: int = 3200, *, nbest: int = 0,
                               lattice: bool = False,
                               ali_info: bool = False,
                               score_info: bool = False,
                               realtime: bool = False) -> S2CPackage:
        """Stream a whole utterance in chunks; returns the final reply.
        ``realtime=True`` paces chunks at audio rate (load-test mode)."""
        samples = np.asarray(samples)
        final: S2CPackage | None = None
        for off in range(0, max(len(samples), 1), chunk_samples):
            chunk = samples[off:off + chunk_samples]
            end = off + chunk_samples >= len(samples)
            final = await self.send_chunk(chunk, end=end, nbest=nbest,
                                          lattice=lattice,
                                          ali_info=ali_info,
                                          score_info=score_info)
            if realtime and not end:
                await asyncio.sleep(len(chunk) / 16000)
        assert final is not None
        return final


def decode_utterance(samples: np.ndarray, host: str = "127.0.0.1",
                     port: int = 8100, **kw) -> S2CPackage:
    """Synchronous one-shot helper (the ctypes-client role,
    ref: client/py-client/client.py:14-60)."""
    async def run():
        c = AsyncAsrClient(host, port)
        await c.connect()
        try:
            return await c.decode_utterance(samples, **kw)
        finally:
            await c.close()
    return asyncio.run(run())


@dataclass
class LoadStats:
    utts: int = 0
    wav_seconds: float = 0.0
    wall_seconds: float = 0.0
    texts: list[str] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        """Aggregate audio-seconds per wall-second (1/RTF)."""
        return self.wav_seconds / self.wall_seconds if self.wall_seconds else 0.0


async def load_generate(waves: list[np.ndarray], *, concurrency: int = 8,
                        host: str = "127.0.0.1", port: int = 8100,
                        chunk_samples: int = 3200,
                        sample_rate: int = 16000) -> LoadStats:
    """Multi-stream load generator (ref: clientbin/thread-client.cc):
    ``concurrency`` simultaneous streaming connections drain the utterance
    list; reports aggregate throughput."""
    queue: asyncio.Queue = asyncio.Queue()
    for w in waves:
        queue.put_nowait(w)
    stats = LoadStats()

    async def worker():
        client = AsyncAsrClient(host, port)
        await client.connect()
        try:
            while True:
                try:
                    wave = queue.get_nowait()
                except asyncio.QueueEmpty:
                    return
                reply = await client.decode_utterance(
                    wave, chunk_samples=chunk_samples)
                stats.utts += 1
                stats.wav_seconds += len(wave) / sample_rate
                stats.texts.append(reply.one_best())
        finally:
            await client.close()

    t0 = time.monotonic()
    await asyncio.gather(*(worker() for _ in range(concurrency)))
    stats.wall_seconds = time.monotonic() - t0
    return stats
