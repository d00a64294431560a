"""Audio ingress: container/codec → 16-bit-scale PCM float32.

Capability parity with the reference's transcode layer
(ref: src/audio-convert/stream2pcm.h:46-118 — FFmpeg any-container → PCM,
an *optional* build) and the protocol's audio-type dispatch
(ref: AUDIOTYPE pcm/wav/opus, src/service2/net-data-package.h:303).

Native WAV (RIFF) parsing covers the common production path; arbitrary
sample rates are linearly resampled to the target (the reference's
LinearResample role, src/pitch/resample.h:124).  Opus/other codecs mirror
the reference's optional-FFmpeg stance: supported when a decoder module is
importable, a clear error otherwise (this image ships none).
"""

from __future__ import annotations

import struct

import numpy as np


class AudioDecodeError(ValueError):
    pass


def parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF/WAVE → (mono float32 samples at 16-bit scale, sample_rate).
    Handles PCM 8/16/24/32-bit and IEEE float32, multi-channel averaged."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE stream")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise AudioDecodeError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 0xFFFE and len(raw) >= 0:   # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits != 32 else 3
    if audio_fmt == 1:          # integer PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32)
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32)
                 - 128.0) * 256.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32))
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x) \
                .astype(np.float32) / 256.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 65536.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:        # IEEE float
        x = np.frombuffer(raw, "<f4").astype(np.float32) * 32768.0
    else:
        raise AudioDecodeError(f"unsupported WAV format tag {audio_fmt}")
    if channels > 1:
        x = x[:len(x) - len(x) % channels].reshape(-1, channels) \
            .mean(axis=1)
    return x, int(rate)


def resample_linear(x: np.ndarray, rate: int, target: int) -> np.ndarray:
    """Linear interpolation resample (the LinearResample role,
    ref: src/pitch/resample.h:124)."""
    if rate == target or len(x) == 0:
        return x
    n_out = int(round(len(x) * target / rate))
    pos = np.arange(n_out, dtype=np.float64) * (rate / target)
    i0 = np.minimum(pos.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (pos - i0).astype(np.float32)
    return (x[i0] * (1.0 - frac) + x[i1] * frac).astype(np.float32)


def ffmpeg_available() -> bool:
    import shutil
    return shutil.which("ffmpeg") is not None


def decode_ffmpeg(data: bytes, target_rate: int = 16000) -> tuple[
        np.ndarray, int]:
    """Any-container decode via an ffmpeg subprocess — the reference's
    optional FFmpeg transcode path (ref: src/audio-convert/stream2pcm.h:
    46-118 avcodec decode loop; optional build, src/audio-convert/
    makefile).  Emits mono s16le at ``target_rate``."""
    import subprocess
    if not ffmpeg_available():
        raise AudioDecodeError(
            "compressed payload but no ffmpeg on PATH (the reference "
            "gates this behind an optional FFmpeg build too)")
    proc = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", "pipe:0", "-f", "s16le",
         "-acodec", "pcm_s16le", "-ac", "1", "-ar", str(target_rate),
         "pipe:1"],
        input=data, capture_output=True, timeout=120)
    if proc.returncode != 0 or not proc.stdout:
        err = proc.stderr.decode(errors="replace")[:200]
        raise AudioDecodeError(f"ffmpeg decode failed: {err}")
    return np.frombuffer(proc.stdout, "<i2").astype(np.float32), target_rate


def decode_opus(data: bytes) -> tuple[np.ndarray, int]:
    """Opus (ogg-container) decode via the optional ffmpeg path."""
    return decode_ffmpeg(data)


def decode_audio(data: bytes, audio_type=None, *, dtype_short: bool = True,
                 target_rate: int = 16000) -> np.ndarray:
    """Payload bytes → mono float32 PCM at 16-bit scale and target rate.

    ``audio_type``: protocol AudioType (0 pcm / 1 wav / 2 opus) or None to
    sniff (RIFF magic ⇒ wav, else raw PCM) — the Stream2Pcm dispatch role.
    """
    at = int(audio_type) if audio_type is not None else \
        (1 if data[:4] == b"RIFF" else 0)
    if at == 1:
        x, rate = parse_wav(data)
        return resample_linear(x, rate, target_rate)
    if at == 2:
        x, rate = decode_opus(data)
        return resample_linear(x, rate, target_rate)
    if dtype_short:
        return np.frombuffer(data, "<i2").astype(np.float32)
    return np.frombuffer(data, "<f4").astype(np.float32)
