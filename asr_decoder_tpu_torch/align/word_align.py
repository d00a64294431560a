"""Word-level time alignment from a best-path arc sequence.

The reference carries per-word time spans to clients as the AlignTime
payload (ref: src/service2/net-data-package.h:210, parsed in the client at
src/client/py-client/asr-client-api.cc:119-126).  This module derives the
spans from the decode best path: walking the arc-id sequence, every arc
with a non-zero input label consumes exactly one scored frame (ref
TraceBackBestPath's "each time you see a nonzero ilabel you can interpret
that as a frame", src/my-decoder/lattice-faster-decoder.h:129-137).

Span convention: consecutive olabel arcs partition the path's emitting
frames into one segment per word.  Which word owns a segment depends on
where the graph puts olabels:

  * ``anchor="start"`` (default): olabels appear at the FIRST arc of a
    word's span (standard composed HCLG — composition pushes labels
    early), so word *i* owns the frames from its olabel arc up to
    (exclusive) word *i+1*'s olabel arc.
  * ``anchor="end"``: olabels appear at the word-EXIT arc (label-pushed-
    late graphs, e.g. ``build_ctc_decode_graph(share_prefixes=True)``
    whose trie moves the olabel to the exit ε arc), so word *i* owns the
    frames since word *i−1*'s olabel arc.

Graphs record their convention as ``StdFst.olabel_anchor``; callers pass
it through so a late-pushed trie graph cannot silently produce shifted
spans.  Frames outside any word segment (silence/ε prefix or suffix)
belong to no word in either convention.
"""

from __future__ import annotations

import numpy as np


def word_spans(arc_ids, arc_ilabel: np.ndarray, arc_olabel: np.ndarray,
               frame_offset: int = 0,
               anchor: str = "start") -> list[tuple[int, int, int]]:
    """[(word_id, begin_frame, end_frame)] for a best-path arc-id sequence.

    ``arc_ilabel``/``arc_olabel`` are the graph's arc label arrays (e.g.
    ``StdFst.arc_ilabel``); frames are counted over arcs with
    ``ilabel != 0`` and offset by ``frame_offset`` (segment base for
    endpoint-resumed streams).  ``end_frame`` is exclusive.  ``anchor``:
    see module docstring ("start" | "end").
    """
    assert anchor in ("start", "end"), anchor
    spans: list[list[int]] = []
    frame = frame_offset
    seg_start = frame_offset
    for a in arc_ids:
        emits = int(arc_ilabel[a]) != 0
        if emits and anchor == "end":
            frame += 1
        ol = int(arc_olabel[a])
        if ol != 0:
            if anchor == "start":
                if spans:
                    spans[-1][2] = frame
                spans.append([ol, frame, frame])
            else:
                spans.append([ol, seg_start, frame])
                seg_start = frame
        if emits and anchor == "start":
            frame += 1
    if spans and anchor == "start":
        spans[-1][2] = frame
    return [tuple(s) for s in spans]


def spans_to_align(spans, words, seconds_per_frame: float
                   ) -> list[tuple[str, float, float]]:
    """AlignTime payload [(word_text, begin_s, end_s)] from frame spans;
    ``words`` is the output SymbolTable."""
    return [(words.find_word(w), b * seconds_per_frame,
             e * seconds_per_frame) for w, b, e in spans]
