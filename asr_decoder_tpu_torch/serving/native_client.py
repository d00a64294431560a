"""ctypes wrapper over the native C++ client library.

Port of ``asr_decoder_tpu/serving/native_client.py``.  The reference
packages its C++ streaming client behind a C ABI (``libclient.so``:
TcpConnect/SendPack/SendLastPack/GetResult, ref:
src/client/py-client/asr-client-api.h:10-24) consumed from Python via
ctypes (ref: src/client/py-client/client.py:14-60).  The same shape here:
``native/asr_client.cc`` (the JAX package's source, byte for byte; it
speaks ``serving/protocol.py``'s wire format) is the C++ library, built
with ``g++`` into the checkout's ``build/`` at first use
(``native/__init__.py``), and this module is the ctypes surface.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from asr_decoder_tpu_torch import native

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class NativeClientUnavailable(RuntimeError):
    pass


def _build_lib() -> str:
    """Compile the shared library (cached on disk under ``build/``)."""
    try:
        return native.build("asr_client")
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeClientUnavailable(
            f"cannot build native client: {e}") from e


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            lib.asr_tcp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.asr_tcp_connect.restype = ctypes.c_int
            lib.asr_send_pack.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.asr_send_pack.restype = ctypes.c_int
            lib.asr_send_pack_ex.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.asr_send_pack_ex.restype = ctypes.c_int
            lib.asr_get_result.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.asr_get_result.restype = ctypes.c_int
            lib.asr_get_result_align.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                ctypes.c_int]
            lib.asr_get_result_align.restype = ctypes.c_int
            lib.asr_close.argtypes = [ctypes.c_int]
            lib.asr_close.restype = None
            _LIB = lib
    return _LIB


class NativeAsrClient:
    """Blocking streaming client over the native library
    (ref client.py:14-60 usage shape: connect → per-chunk send+result →
    final)."""

    def __init__(self, host: str, port: int):
        self._l = _lib()
        self._fd = self._l.asr_tcp_connect(host.encode(), int(port))
        if self._fd < 0:
            raise ConnectionError(f"connect {host}:{port} failed")
        self._seq = 0
        self.last_align: list[tuple[str, float, float]] = []

    def send_chunk(self, samples: np.ndarray, *, eos: bool = False,
                   nbest: int = 0, ali_info: bool = False
                   ) -> tuple[str, int]:
        """Send one PCM chunk (float/int samples at 16 kHz) and read the
        reply; returns (one-best text, end_flag).  With ``ali_info`` the
        per-word time spans of the reply are kept on ``self.last_align``
        as [(word, begin_s, end_s)] (ref AlignTime parse,
        src/client/py-client/asr-client-api.cc:119-126)."""
        pcm = np.asarray(samples).astype("<i2").tobytes()
        rc = self._l.asr_send_pack_ex(self._fd, pcm, len(pcm),
                                      int(self._seq == 0), int(eos),
                                      int(nbest), 0, int(ali_info), 0,
                                      self._seq)
        if rc != 0:
            raise ConnectionError("send failed")
        self._seq += 1
        buf = ctypes.create_string_buffer(1 << 16)
        abuf = ctypes.create_string_buffer(1 << 16)
        end = ctypes.c_int(0)
        nres = self._l.asr_get_result_align(self._fd, buf, len(buf),
                                            ctypes.byref(end), abuf,
                                            len(abuf))
        if nres < 0:
            raise ConnectionError("receive failed")
        # tolerate a truncated trailing line (the align buffer is fixed
        # size and asr_get_result_align may cut mid-line) or stray tabs:
        # only well-formed "word\tbegin\tend" lines are kept
        align = []
        for line in abuf.value.decode("utf-8", "replace").splitlines():
            parts = line.rsplit("\t", 2)
            if len(parts) != 3:
                continue
            try:
                align.append((parts[0], float(parts[1]), float(parts[2])))
            except ValueError:
                continue
        self.last_align = align
        return buf.value.decode("utf-8"), int(end.value)

    def decode_utterance(self, wave: np.ndarray, chunk: int = 4000,
                         nbest: int = 0) -> str:
        """Stream a whole utterance in chunks; returns the final text."""
        wave = np.asarray(wave)
        text = ""
        for i in range(0, max(len(wave), 1), chunk):
            part = wave[i:i + chunk]
            eos = i + chunk >= len(wave)
            text, end = self.send_chunk(part, eos=eos, nbest=nbest)
            if end == 2:
                break
        return text

    def close(self) -> None:
        if self._fd >= 0:
            self._l.asr_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
