"""ctypes surface over the native lattice-ops library.

Port of ``asr_decoder_tpu/fst/native_nbest.py``: the irregular host-side
lattice algebra stays native (the reference's C++ NShortestPath,
src/newfst/lattice-to-nbest.cc:15-147).  ``native/lattice_ops.cc`` (the
JAX package's source, byte for byte) implements n-shortest-path extraction
over the binary lattice format with exactly ``fst/nbest.py::nshortest``'s
semantics; this module builds it with ``g++`` into the checkout's
``build/`` at first use (``native/__init__.py``) and loads it.  Callers
fall back to the Python implementation when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import threading

from asr_decoder_tpu_torch import native

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_UNAVAILABLE = False


def _lib() -> ctypes.CDLL | None:
    global _LIB, _UNAVAILABLE
    with _LOCK:
        if _LIB is not None or _UNAVAILABLE:
            return _LIB
        try:
            lib = ctypes.CDLL(native.build("lattice_ops"))
        except (OSError, subprocess.CalledProcessError):
            _UNAVAILABLE = True
            return None
        lib.lat_nbest.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.lat_nbest.restype = ctypes.c_int
        lib.lat_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.lat_free.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _lib() is not None


def nshortest_bytes(data: bytes, n: int, *, unique_words: bool = True
                    ) -> list[dict] | None:
    """n-best over serialized lattice bytes via the native library;
    returns [{words, ilabels, graph_cost, am_cost}] or None when the
    library cannot be built (caller falls back to Python)."""
    lib = _lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t(0)
    rc = lib.lat_nbest(data, len(data), int(n), int(unique_words),
                       ctypes.byref(out), ctypes.byref(out_len))
    try:
        if rc == -2:
            raise MemoryError("native n-best result allocation failed")
        if rc < 0:
            raise ValueError("malformed lattice bytes")
        buf = ctypes.string_at(out, out_len.value) if out_len.value else b""
    finally:
        if out:
            lib.lat_free(out)
    results = []
    off = 0
    for _ in range(rc):
        (nw,) = struct.unpack_from("<I", buf, off)
        off += 4
        words = list(struct.unpack_from(f"<{nw}i", buf, off))
        off += 4 * nw
        (ni,) = struct.unpack_from("<I", buf, off)
        off += 4
        ilabels = list(struct.unpack_from(f"<{ni}i", buf, off))
        off += 4 * ni
        g, a = struct.unpack_from("<ff", buf, off)
        off += 8
        results.append(dict(words=words, ilabels=ilabels,
                            graph_cost=g, am_cost=a))
    return results
