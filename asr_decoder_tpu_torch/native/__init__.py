"""Native host libraries: C++ sources built with ``g++`` at first use.

``lattice_ops.cc`` (the n-shortest paths of a lattice,
``fst/native_nbest.py``) and ``asr_client.cc`` (the streaming client,
``serving/native_client.py``) are the JAX package's sources, byte for
byte.  Each builds into ``build/asr_decoder_tpu_torch/native/`` of the
checkout under a name keyed by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Concurrent builds
(test workers, server processes) each compile into a per-pid temporary
file and ``os.replace`` it into place, so a reader never sees a partial
library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "asr_decoder_tpu_torch" / \
    "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def build(name: str) -> str:
    """Path of the shared library of ``<name>.cc``, compiled if missing.
    Raises ``OSError`` (no ``g++``) or ``subprocess.CalledProcessError``
    (the compile failed)."""
    src = NATIVE_DIR / f"{name}.cc"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}-{key[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return str(so)
