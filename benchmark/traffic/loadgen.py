"""The serving cells' load generator: a process of its own, so that the
clients' Python never holds the server's interpreter lock.  It speaks the
server's wire protocol over localhost (the benchmark's own framing of
``serving/protocol.py``: a C2S head and 16-bit PCM a push, an S2C reply
framed by its length) and imports neither torch nor the program.

    python -m benchmark.traffic.loadgen    # one JSON job on stdin

It prints ``{"t_base": ...}`` once its clock is set, then one JSON line of
what happened.  Times are ``time.monotonic()``, which the parent shares.

``clients`` connections each stream one utterance after another (a
closed loop), every push sent as soon as the previous reply came; a
finished utterance's connection is replaced at once.  Pushes are not sent
once the window has ended, except the last push of an utterance; what is
in flight is waited for, up to ``grace_s``."""

from __future__ import annotations

import asyncio
import json
import struct
import sys
import time

import numpy as np

from benchmark import inputs

MAGIC_C2S = 0x43325331
MAGIC_S2C = 0x53324331
C2S_HEAD = struct.Struct("<IBBBBBBBBBBBII")
S2C_HEAD = struct.Struct("<IBBBBBBBI")
END = 2
SAMPLE_RATE = 16000
UID_SHIFT = 12          # a push's sequence number: uid << 12 | push index


def pack(pcm: np.ndarray, first: bool, last: bool, n: int) -> bytes:
    data = pcm.astype("<i2").tobytes()
    return C2S_HEAD.pack(MAGIC_C2S, 0, 16, 0, 0, int(first), 0, 0, 0, 0,
                         int(last), 0, n, len(data)) + data


async def read_reply(reader) -> tuple[int, list, float]:
    """(end flag, words of the best result, its cost)."""
    (n,) = struct.unpack("<I", await reader.readexactly(4))
    buf = await reader.readexactly(n)
    magic, end, *_, nres = S2C_HEAD.unpack_from(buf, 0)
    if magic != MAGIC_S2C:
        raise ValueError(f"bad S2C magic 0x{magic:x}")
    words, cost = [], 0.0
    if nres:
        off = S2C_HEAD.size
        (tl,) = struct.unpack_from("<I", buf, off)
        off += 4 + tl
        cost, _ = struct.unpack_from("<ff", buf, off)
        off += 8
        (nw,) = struct.unpack_from("<I", buf, off)
        words = np.frombuffer(buf, "<i4", nw, off + 4).tolist()
    return end, words, float(cost)


def lengths(job: dict) -> np.ndarray:
    """Lengths in s of the ``pool`` utterances the clients take in turn:
    the same set for every seed, in an order drawn from the seed."""
    p = job["params"]
    L = p["length"]
    return inputs.utterance_lengths(p["pool"], job["seed"], L["median_s"],
                                    L["sigma"], L["min_s"], L["max_s"])


class Gen:
    def __init__(self, job: dict):
        self.job = job
        self.p = job["params"]
        self.seed = job["seed"]
        self.lengths = lengths(job)
        self.pushes = []        # [uid, k, sent, replied (or None), eos, audio_s]
        self.finals = {}        # uid -> [words, cost]
        self.failed = []        # uids whose stream broke

    async def _utterance(self, uid: int, stop_at: float) -> None:
        host, port = self.job["host"], self.job["port"]
        audio = inputs.wave(self.seed, uid, float(self.lengths[
            uid % len(self.lengths)]))
        step = int(self.p["push_s"] * SAMPLE_RATE)
        n = max(1, -(-len(audio) // step))
        writer = None
        try:
            reader, writer = await asyncio.open_connection(host, port)
            for k in range(n):
                chunk = audio[k * step:(k + 1) * step]
                last = k == n - 1
                sent = time.monotonic()
                if sent >= stop_at and not last:
                    break
                rec = [uid, k, sent, None, last, len(chunk) / SAMPLE_RATE]
                self.pushes.append(rec)
                writer.write(pack(chunk, k == 0, last,
                                  (uid << UID_SHIFT) | k))
                await writer.drain()
                end, words, cost = await read_reply(reader)
                rec[3] = time.monotonic()
                if last:
                    if end != END:
                        raise ValueError(f"last push answered {end}")
                    self.finals[uid] = [words, cost]
        except (OSError, ValueError, asyncio.IncompleteReadError) as e:
            self.failed.append([uid, repr(e)])
        finally:
            if writer is not None:
                writer.close()
                try:
                    await writer.wait_closed()
                except OSError:
                    pass

    async def run(self, t_base: float) -> None:
        p = self.p
        t_end = t_base + p["warm_s"] + self.job["seconds"]
        counter = iter(range(1 << 19))

        async def client():
            while time.monotonic() < t_end:
                await self._utterance(next(counter), t_end)
        tasks = [asyncio.ensure_future(client())
                 for _ in range(p["clients"])]
        done, pending = await asyncio.wait(
            tasks, timeout=max(0.0, t_end + p["grace_s"] - time.monotonic()))
        for t in pending:
            t.cancel()
        for t in done:
            t.result()


def main() -> int:
    job = json.loads(sys.stdin.readline())
    gen = Gen(job)
    t_base = time.monotonic() + 0.5
    print(json.dumps({"t_base": t_base}), flush=True)
    asyncio.run(gen.run(t_base))
    print(json.dumps({"pushes": gen.pushes, "finals": gen.finals,
                      "failed": gen.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
