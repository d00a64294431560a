"""Post-processing (second-pass LM rescore) service.

Capability parity with the reference's standalone rescoring service
(ref: src/post-processing-service/asr-post-process-service.cc + task loop
asr-post-process-task.h:27-130): a second TCP service that receives a
lattice (+ optional n-best request), applies a const-ARPA-style LM rescore
with **add** or **replace** scale modes (ref ConstArpaLmDeterministicFstScale,
const-lm-rescore.h:66-153; KaldiConstArpaLmRescore::Compose :156-205), turns
the rescored lattice into ranked results (ref lattice-to-result.h:15), and
replies.  A punctuate hook mirrors the reference's stub.

Service-level pipeline parallelism (SURVEY §2.10): ASR decode and rescoring
run in separate processes connected by TCP — rescoring is host-side lattice
algebra (compose with a deterministic LM automaton), so it scales on CPUs
while the chips stay on the beam-search hot path.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field

from asr_decoder_tpu_torch.fst import native_nbest
from asr_decoder_tpu_torch.fst.lattice import Lattice
from asr_decoder_tpu_torch.fst.nbest import nshortest
from asr_decoder_tpu_torch.lm.arpa import Fsa
from asr_decoder_tpu_torch.lm.compose import (ComposeArpaLm, DiffArpaLm,
                                              compose_lattice)
from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.utils.logging import get_logger

LOG = get_logger("post")

MAGIC_P2S = 0x50325331      # "P2S1"
MAGIC_S2P = 0x53325031      # "S2P1"

MODE_ADD = 0                # new_cost = old + scale·lm2
MODE_REPLACE = 1            # new_cost = old − scale·lm1 + scale·lm2


@dataclass
class PostConfig:
    """ref: the post service's conf surface
    (post-processing-service/asr-post-process-service.cc flags)."""
    ip: str = flag("127.0.0.1", "Listen address")
    port: int = flag(8200, "Listen port")
    lm_scale: float = flag(1.0, "Default rescore LM scale")
    rec_timeout: int = flag(30, "Per-package receive timeout (s)")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


@dataclass
class PostRequest:
    """Client→post package: lattice + rescore knobs."""
    mode: int = MODE_ADD
    lm_scale: float = 1.0
    nbest: int = 1
    punctuate: bool = False     # hook only (ref stub)
    lattice: bytes = b""

    HEAD = struct.Struct("<IBdIBI")    # magic mode scale nbest punct latlen

    def pack(self) -> bytes:
        return self.HEAD.pack(MAGIC_P2S, self.mode, self.lm_scale,
                              self.nbest, int(self.punctuate),
                              len(self.lattice)) + self.lattice

    @classmethod
    async def read(cls, reader) -> "PostRequest":
        head = await reader.readexactly(cls.HEAD.size)
        magic, mode, scale, nbest, punct, n = cls.HEAD.unpack(head)
        if magic != MAGIC_P2S:
            raise ValueError(f"bad P2S magic 0x{magic:x}")
        data = await reader.readexactly(n) if n else b""
        return cls(mode, scale, nbest, bool(punct), data)


@dataclass
class PostResult:
    words: list[int] = field(default_factory=list)
    graph_cost: float = 0.0
    am_cost: float = 0.0


@dataclass
class PostResponse:
    ok: bool = True
    results: list[PostResult] = field(default_factory=list)
    lattice: bytes = b""        # rescored lattice (round-trippable)

    def pack(self) -> bytes:
        out = [struct.pack("<IBII", MAGIC_S2P, int(self.ok),
                           len(self.results), len(self.lattice))]
        for r in self.results:
            out.append(struct.pack("<Iff", len(r.words), r.graph_cost,
                                   r.am_cost))
            out.append(struct.pack(f"<{len(r.words)}i", *r.words))
        out.append(self.lattice)
        return b"".join(out)

    @classmethod
    async def read(cls, reader) -> "PostResponse":
        magic, ok, nres, latlen = struct.unpack(
            "<IBII", await reader.readexactly(13))
        if magic != MAGIC_S2P:
            raise ValueError(f"bad S2P magic 0x{magic:x}")
        results = []
        for _ in range(nres):
            nw, g, a = struct.unpack("<Iff", await reader.readexactly(12))
            words = list(struct.unpack(
                f"<{nw}i", await reader.readexactly(4 * nw)))
            results.append(PostResult(words, g, a))
        lattice = await reader.readexactly(latlen) if latlen else b""
        return cls(bool(ok), results, lattice)


class ConstLmRescorer:
    """Lattice rescoring with add / replace scale modes.

    * add: compose with scale·G₂ — graph costs gain the new LM score
      (ref ConstArpaLmDeterministicFstScale 'add' path,
      const-lm-rescore.h:66-153);
    * replace: compose with the difference automaton scale·(G₂ − G₁) —
      the first-pass LM score is subtracted as the new one is added
      (ref DiffArpaLm semantics, src/newlm/diff-lm.h:13-122).
    """

    def __init__(self, lm2: Fsa, lm1: Fsa | None = None):
        self.lm2 = lm2
        self.lm1 = lm1

    def rescore(self, lat: Lattice, mode: int, scale: float) -> Lattice:
        if mode == MODE_ADD:
            return compose_lattice(lat, ComposeArpaLm(self.lm2, scale))
        assert mode == MODE_REPLACE, mode
        assert self.lm1 is not None, "replace mode needs the first-pass LM"
        return compose_lattice(
            lat, DiffArpaLm(self.lm1, self.lm2, lm1_scale=scale,
                            lm2_scale=scale))


class PostServer:
    """The second-pass service (ref asr-post-process-service.cc:28)."""

    def __init__(self, rescorer: ConstLmRescorer,
                 config: PostConfig | None = None):
        self.rescorer = rescorer
        self.config = config or PostConfig()
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.config.ip, self.config.port)
        addr = self._server.sockets[0].getsockname()[:2]
        LOG.info("post service on %s:%d", *addr)
        return addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                try:
                    req = await asyncio.wait_for(PostRequest.read(reader),
                                                 self.config.rec_timeout)
                except (asyncio.IncompleteReadError, ConnectionError,
                        asyncio.TimeoutError):
                    break
                writer.write(self._process(req).pack())
                await writer.drain()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    def _process(self, req: PostRequest) -> PostResponse:
        """Rescore + lattice→results (ref task loop
        asr-post-process-task.h:27-130, lattice-to-result.h:15)."""
        try:
            lat = Lattice.from_bytes(req.lattice)
            scale = req.lm_scale or self.config.lm_scale
            res = self.rescorer.rescore(lat, req.mode, scale)
            lat_bytes = res.to_bytes()
            out = PostResponse(lattice=lat_bytes)
            # lattice→ranked results: native C++ n-shortest when a
            # toolchain exists (fst/native_nbest.py, parity-tested vs the
            # Python path), Python fallback otherwise
            got = native_nbest.nshortest_bytes(lat_bytes,
                                               max(1, req.nbest))
            if got is not None:
                out.results = [PostResult(r["words"], r["graph_cost"],
                                          r["am_cost"]) for r in got]
            else:
                for p in nshortest(res, max(1, req.nbest)):
                    words = [a.olabel for a in p.arcs if a.olabel != 0]
                    out.results.append(PostResult(words, p.graph_cost,
                                                  p.am_cost))
            return out
        except Exception as e:          # malformed input must not kill
            LOG.warning("rescore failed: %s", e)
            return PostResponse(ok=False)


async def rescore_via_service(lattice: Lattice, host: str, port: int, *,
                              mode: int = MODE_ADD, lm_scale: float = 1.0,
                              nbest: int = 1) -> PostResponse:
    """Client helper: one round trip to the post service (the
    client-asr-post-process forwarding role,
    ref: post-processing-service/client-asr-post-process-*)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(PostRequest(mode, lm_scale, nbest, False,
                                 lattice.to_bytes()).pack())
        await writer.drain()
        return await PostResponse.read(reader)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


def run_post_server(rescorer: ConstLmRescorer,
                    config: PostConfig | None = None) -> None:
    asyncio.run(PostServer(rescorer, config).serve_forever())
