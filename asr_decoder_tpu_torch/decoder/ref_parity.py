"""Cross-implementation parity harness against the REFERENCE C++ decoder.

Builds the reference's ``LatticeFasterDecoder`` core Kaldi-free from
the reference source tree at ``REF_ROOT`` (two headers are shadow-patched
at build time, see ``tools/refparity/build.sh``) and drives it over a graph serialized by
``StdFst.write_binary`` (byte-identical to the format ref ``ReadFst``
expects, ref: src/newfst/optimize-fst.h:226-280) plus a raw loglikes
matrix.  This converts the repo's parity evidence from self-referential
(device kernel vs our own gold Python decoder) to externally anchored:
the same (graph, loglikes) must produce identical words and cost through
the actual reference implementation
(ref: src/my-decoder/lattice-faster-decoder.cc).

A copy of ``asr_decoder_tpu/decoder/ref_parity.py``: from this mirrored
path ``_TOOLS_DIR`` still resolves to the repository's ``tools/refparity``.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np

# the same default location as the original module's
REF_ROOT = os.path.join(os.sep, "root", "reference")
_TOOLS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tools",
                          "refparity")


def available(ref_root: str = REF_ROOT) -> bool:
    """True when the reference tree + a C++ toolchain are present."""
    return (os.path.isdir(os.path.join(ref_root, "src", "my-decoder"))
            and shutil.which("g++") is not None)


def build(build_dir: str, ref_root: str = REF_ROOT) -> str:
    """Compile the parity binary into ``build_dir`` (cached); returns its
    path."""
    binary = os.path.join(build_dir, "refparity_main")
    if not os.path.exists(binary):
        subprocess.run(
            ["sh", os.path.join(_TOOLS_DIR, "build.sh"), build_dir,
             ref_root],
            check=True, capture_output=True, text=True)
    return binary


def run(binary: str, fst, loglikes: np.ndarray, i2p: np.ndarray, *,
        acoustic_scale: float = 1.0, beam: float = 1e9,
        max_active: int = 1 << 30, min_active: int = 0,
        nbest: int = 0, workdir: str | None = None) -> dict:
    """Decode (fst, loglikes) through the reference LatticeFasterDecoder.

    Returns {nonempty, cost, graph_cost, acoustic_cost, words, ilabels}
    plus, with ``nbest`` > 0, ``nbest``: a list of {cost, graph_cost,
    words} dicts through the reference's own lattice pipeline
    (GetRawLattice → DeterminizeLatticeWrapper → NShortestPath,
    ref: src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.cc:97-105).
    ``loglikes`` f32[T, V] unscaled (the decodable applies
    ``acoustic_scale``, like the reference AM wrapper); ``i2p[ilabel]`` =
    AM output row scored for that arc input label.
    """
    loglikes = np.ascontiguousarray(loglikes, np.float32)
    i2p = np.ascontiguousarray(i2p, np.int32)
    T, V = loglikes.shape
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="refparity_")
    try:
        graph_path = os.path.join(workdir, "graph.fst")
        blob_path = os.path.join(workdir, "input.blob")
        fst.write_binary(graph_path)
        with open(blob_path, "wb") as f:
            f.write(struct.pack("<iiif", T, V, len(i2p),
                                float(acoustic_scale)))
            i2p.tofile(f)
            loglikes.tofile(f)
        proc = subprocess.run(
            [binary, graph_path, blob_path, repr(float(beam)),
             str(int(max_active)), str(int(min_active)),
             str(int(nbest))],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"refparity_main failed ({proc.returncode}): {proc.stderr}")
        out: dict = {}
        for line in proc.stdout.splitlines():
            key, _, val = line.partition("=")
            if key == "frames":
                out["frames"] = int(val)
            elif key == "nonempty":
                out["nonempty"] = bool(int(val))
            elif key == "cost":
                parts = line.replace("=", " ").split()
                out["cost"] = float(parts[1])
                out["graph_cost"] = float(parts[3])
                out["acoustic_cost"] = float(parts[5])
            elif key in ("words", "ilabels"):
                out[key] = [int(x) for x in val.split()] if val else []
            elif key == "arcs":
                out["arcs"] = [tuple(int(x) for x in p.split(":"))
                               for p in val.split()] if val else []
            elif key == "nbest":
                out["nbest"] = []
            elif key.startswith("nb") and key[2:].split()[0].isdigit():
                parts = line.split("words=")
                head = parts[0].replace("=", " ").split()
                out["nbest"].append(dict(
                    cost=float(head[2]), graph_cost=float(head[4]),
                    words=[int(x) for x in parts[1].split()]
                    if len(parts) > 1 and parts[1] else []))
        return out
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
