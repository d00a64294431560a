"""Binary wire protocol for the streaming ASR service.

Capability parity with the reference protocol
(ref: src/service2/net-data-package.h): a client→server (C2S) head carrying
audio-format + feature-request bitfields and a length-prefixed PCM payload,
and a server→client (S2C) head carrying end-state + result bitfields with
length-prefixed n-best strings / align / score payloads.  Field-for-field
semantics are kept (same enums, same 3-state end flag, same nbest cap of 63)
so the edge API surface matches; the byte layout is a clean little-endian
struct encoding rather than C bitfields (which are compiler-defined), and it
works over any bytes transport (asyncio TCP here, ref: blocking ReadN/WriteN
src/util/io-funcs.h:69-71).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

MAGIC_C2S = 0x43325331  # "C2S1"
MAGIC_S2C = 0x53324331  # "S2C1"
NBEST_MAX = 63          # ref: 6-bit _nbest field, net-data-package.h:252-296


class DType(IntEnum):
    """ref: DTYPE (net-data-package.h:301)."""
    SHORT = 0
    FLOAT = 1


class AudioType(IntEnum):
    """ref: AUDIOTYPE (net-data-package.h:303)."""
    PCM = 0
    WAV = 1
    OPUS = 2


class SampleRate(IntEnum):
    """ref: sample-rate bitfield (net-data-package.h:260)."""
    K16 = 0
    K8 = 1
    K32 = 2

    @property
    def hz(self) -> int:
        return {0: 16000, 1: 8000, 2: 32000}[int(self)]


class EndFlag(IntEnum):
    """ref: S2CENDFLAG (net-data-package.h:551)."""
    NOEND = 0
    MIDDLEEND = 1
    END = 2


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode("utf-8"), off + n


@dataclass
class C2SPackage:
    """Client→server chunk (ref: C2SPackageHead, net-data-package.h:252-296)."""
    dtype: DType = DType.SHORT
    bit: int = 16
    sample_rate: SampleRate = SampleRate.K16
    audio_type: AudioType = AudioType.PCM
    audio_head: bool = False      # first package of the stream
    lattice: bool = False         # client wants the lattice back
    ali_info: bool = False
    score_info: bool = False
    nbest: int = 0                # 0..63
    end_flag: bool = False        # last package of the utterance
    keep: int = 0                 # reserved (ref _keep)
    n: int = 0                    # package sequence number (ref _n)
    data: bytes = b""             # raw PCM payload

    HEAD = struct.Struct("<IBBBBBBBBBBBII")  # magic, 11 flag bytes, n, data_len

    def pack(self) -> bytes:
        if not 0 <= self.nbest <= NBEST_MAX:
            raise ValueError("nbest out of range 0..63")
        return self.HEAD.pack(
            MAGIC_C2S, int(self.dtype), self.bit, int(self.sample_rate),
            int(self.audio_type), int(self.audio_head), int(self.lattice),
            int(self.ali_info), int(self.score_info), self.nbest,
            int(self.end_flag), self.keep, self.n, len(self.data)) + self.data

    @classmethod
    def head_size(cls) -> int:
        return cls.HEAD.size

    @classmethod
    def unpack_head(cls, buf: bytes) -> tuple["C2SPackage", int]:
        """Parse the fixed head; returns (package-without-data, data_len)."""
        (magic, dtype, bit, sr, at, head, lat, ali, score, nbest, end,
         keep, n, dlen) = cls.HEAD.unpack(buf)
        if magic != MAGIC_C2S:
            raise ValueError(f"bad C2S magic 0x{magic:x}")
        return cls(DType(dtype), bit, SampleRate(sr), AudioType(at),
                   bool(head), bool(lat), bool(ali), bool(score), nbest,
                   bool(end), keep, n), dlen

    # -- payload helpers (ref: C2SPackageAnalysis::GetData) ---------------
    def samples(self) -> np.ndarray:
        """Decode the payload to float32 samples at 16-bit PCM scale,
        honoring ``audio_type`` (wav containers are parsed + resampled to
        the declared rate; a WAV payload must arrive in one package —
        ref Stream2Pcm dispatch, src/audio-convert/stream2pcm.h:46-118)."""
        if self.audio_type != AudioType.PCM:
            from asr_decoder_tpu_torch.frontend.audio import decode_audio
            return decode_audio(self.data, int(self.audio_type),
                                dtype_short=(self.dtype == DType.SHORT),
                                target_rate=self.sample_rate.hz)
        if self.dtype == DType.SHORT:
            return np.frombuffer(self.data, "<i2").astype(np.float32)
        return np.frombuffer(self.data, "<f4").astype(np.float32)

    @staticmethod
    def from_samples(samples: np.ndarray, *, dtype: DType = DType.SHORT,
                     **kw) -> "C2SPackage":
        if dtype == DType.SHORT:
            data = np.asarray(samples).astype("<i2").tobytes()
        else:
            data = np.asarray(samples).astype("<f4").tobytes()
        return C2SPackage(dtype=dtype, data=data, **kw)


@dataclass
class NbestResult:
    text: str
    graph_cost: float = 0.0
    am_cost: float = 0.0
    words: list[int] = field(default_factory=list)


@dataclass
class S2CPackage:
    """Server→client result (ref: S2CPackageHead + payloads,
    net-data-package.h:561-755).

    ``align``: per-word time spans [(word_text, begin_s, end_s)] — the
    reference's AlignTime payload (ref: net-data-package.h:210
    ``vector<pair<string, pair<float,float>>>``), present iff ``ali_info``.
    The align section is packed after the n-best results and before the
    lattice, so clients that ignore trailing payloads stay compatible.

    ``warn``: per-utterance quality warning bit — set when the BigLM
    search dropped word candidates to lm_lanes overflow (the reference
    never drops, ref: online-decoder-mempool-base-biglm.h:316-402, so a
    drop must be visible to clients, not just server logs).
    """
    end_flag: EndFlag = EndFlag.NOEND
    do_rescore: bool = False
    do_punctuate: bool = False
    ali_info: bool = False
    score_info: bool = False
    lattice: bytes = b""          # serialized lattice (optional)
    results: list[NbestResult] = field(default_factory=list)
    align: list[tuple[str, float, float]] = field(default_factory=list)
    warn: bool = False

    HEAD = struct.Struct("<IBBBBBBBI")  # magic, flags..., warn, nres

    def pack(self) -> bytes:
        out = [self.HEAD.pack(
            MAGIC_S2C, int(self.end_flag), int(self.do_rescore),
            int(self.do_punctuate), int(self.ali_info), int(self.score_info),
            int(bool(self.lattice)), int(self.warn), len(self.results))]
        for r in self.results:
            out.append(_pack_str(r.text))
            out.append(struct.pack("<ff", r.graph_cost, r.am_cost))
            out.append(struct.pack("<I", len(r.words)))
            out.append(np.asarray(r.words, "<i4").tobytes())
        if self.ali_info:
            out.append(struct.pack("<I", len(self.align)))
            for word, b, e in self.align:
                out.append(_pack_str(word))
                out.append(struct.pack("<ff", b, e))
        if self.lattice:
            out.append(struct.pack("<I", len(self.lattice)))
            out.append(self.lattice)
        return b"".join(out)

    @classmethod
    def unpack(cls, buf: bytes) -> "S2CPackage":
        (magic, end, resc, punc, ali, score, has_lat, warn, nres) = \
            cls.HEAD.unpack_from(buf, 0)
        if magic != MAGIC_S2C:
            raise ValueError(f"bad S2C magic 0x{magic:x}")
        off = cls.HEAD.size
        results = []
        for _ in range(nres):
            text, off = _unpack_str(buf, off)
            g, a = struct.unpack_from("<ff", buf, off)
            off += 8
            (nw,) = struct.unpack_from("<I", buf, off)
            off += 4
            words = np.frombuffer(buf, "<i4", nw, off).tolist()
            off += 4 * nw
            results.append(NbestResult(text, g, a, words))
        align: list[tuple[str, float, float]] = []
        if ali:
            (na,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _ in range(na):
                word, off = _unpack_str(buf, off)
                b, e = struct.unpack_from("<ff", buf, off)
                off += 8
                align.append((word, b, e))
        lattice = b""
        if has_lat:
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            lattice = bytes(buf[off:off + n])
        return cls(EndFlag(end), bool(resc), bool(punc), bool(ali),
                   bool(score), lattice, results, align, bool(warn))

    def one_best(self) -> str:
        return self.results[0].text if self.results else ""


# ----------------------------------------------------------------------
# framed stream IO (ref: ReadN/WriteN full-buffer loops, io-funcs.h:69-71)
# ----------------------------------------------------------------------

async def read_c2s(reader) -> C2SPackage:
    head = await reader.readexactly(C2SPackage.head_size())
    pkg, dlen = C2SPackage.unpack_head(head)
    pkg.data = await reader.readexactly(dlen) if dlen else b""
    return pkg


async def read_s2c(reader) -> S2CPackage:
    """S2C framing: 4-byte total length prefix then the package."""
    (n,) = struct.unpack("<I", await reader.readexactly(4))
    return S2CPackage.unpack(await reader.readexactly(n))


def frame_s2c(pkg: S2CPackage) -> bytes:
    body = pkg.pack()
    return struct.pack("<I", len(body)) + body
