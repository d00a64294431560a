"""Kaldi-compatible HMM transition model.

Capability parity with the reference ``TransitionModel``/``HmmTopology``
(ref: src/hmm/transition-model.{h,cc}, src/hmm/hmm-topology.{h,cc}): reads
Kaldi ``final.mdl`` transition-model sections (text and binary), maps
transition-ids ↔ (phone, hmm-state, pdf), provides the decoder's
``transition_id_to_pdf`` table and the CTC +1 pdf shift
(ref: ExchangePdfId, transition-model.h:11-106).

Supports both the old ``<Triples>`` layout the reference reads and modern
Kaldi ``<Tuples>`` (forward/self-loop pdfs).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np


# ----------------------------------------------------------------------
# Kaldi-style token/value stream over text or binary data
# (the IO behavior of ref: src/util/io-funcs.h:24-71)
# ----------------------------------------------------------------------

class KaldiStream:
    def __init__(self, data: bytes):
        self.binary = data.startswith(b"\0B")
        self.buf = io.BytesIO(data[2:] if self.binary else data)

    def read_token(self) -> str:
        # skip whitespace
        out = []
        while True:
            c = self.buf.read(1)
            if not c:
                return ""
            if not c.isspace():
                out.append(c)
                break
        while True:
            c = self.buf.read(1)
            if not c or c.isspace():
                break
            out.append(c)
        return b"".join(out).decode()

    def expect_token(self, tok: str) -> None:
        got = self.read_token()
        if got != tok:
            raise IOError(f"expected {tok}, got {got!r}")

    def peek_token(self) -> str:
        pos = self.buf.tell()
        tok = self.read_token()
        self.buf.seek(pos)
        return tok

    def read_int(self) -> int:
        if self.binary:
            self._skip_ws()
            (sz,) = self.buf.read(1)
            if sz == 4:
                return struct.unpack("<i", self.buf.read(4))[0]
            if sz == 8:
                return struct.unpack("<q", self.buf.read(8))[0]
            raise IOError(f"bad int size {sz}")
        return int(self.read_token())

    def read_float(self) -> float:
        if self.binary:
            self._skip_ws()
            (sz,) = self.buf.read(1)
            if sz == 4:
                return struct.unpack("<f", self.buf.read(4))[0]
            if sz == 8:
                return struct.unpack("<d", self.buf.read(8))[0]
            raise IOError(f"bad float size {sz}")
        return float(self.read_token())

    def _skip_ws(self):
        while True:
            pos = self.buf.tell()
            c = self.buf.read(1)
            if not c or not c.isspace():
                self.buf.seek(pos)
                return

    def read_vector(self) -> np.ndarray:
        if self.binary:
            tok = self.read_token()
            if tok not in ("FV", "DV"):
                raise IOError(f"expected FV/DV, got {tok!r}")
            n = self.read_int()
            dt = "<f4" if tok == "FV" else "<f8"
            a = np.frombuffer(self.buf.read(n * np.dtype(dt).itemsize), dt)
            return a.astype(np.float32)
        self.expect_token("[")
        vals = []
        while True:
            tok = self.read_token()
            if tok == "]":
                break
            vals.append(float(tok))
        return np.array(vals, np.float32)


# ----------------------------------------------------------------------
# HmmTopology (ref: src/hmm/hmm-topology.{h,cc})
# ----------------------------------------------------------------------

@dataclass
class TopologyState:
    pdf_class: int = -1            # forward pdf class (-1 = non-emitting)
    self_loop_pdf_class: int = -1
    transitions: list[tuple[int, float]] = field(default_factory=list)


@dataclass
class HmmTopology:
    # phone -> list of TopologyState
    entries: dict[int, list[TopologyState]] = field(default_factory=dict)

    @staticmethod
    def read(s: KaldiStream) -> "HmmTopology":
        topo = HmmTopology()
        s.expect_token("<Topology>")
        while True:
            tok = s.read_token()
            if tok == "</Topology>":
                break
            if tok != "<TopologyEntry>":
                raise IOError(f"bad topology token {tok!r}")
            s.expect_token("<ForPhones>")
            phones = []
            while True:
                t = s.peek_token()
                if t == "</ForPhones>":
                    s.read_token()
                    break
                phones.append(s.read_int())
            states: list[TopologyState] = []
            while True:
                t = s.read_token()
                if t == "</TopologyEntry>":
                    break
                if t != "<State>":
                    raise IOError(f"bad state token {t!r}")
                s.read_int()  # state index (sequential)
                st = TopologyState()
                while True:
                    t2 = s.read_token()
                    if t2 == "</State>":
                        break
                    if t2 == "<PdfClass>":
                        st.pdf_class = s.read_int()
                        st.self_loop_pdf_class = st.pdf_class
                    elif t2 == "<ForwardPdfClass>":
                        st.pdf_class = s.read_int()
                    elif t2 == "<SelfLoopPdfClass>":
                        st.self_loop_pdf_class = s.read_int()
                    elif t2 == "<Transition>":
                        dst = s.read_int()
                        prob = s.read_float()
                        st.transitions.append((dst, prob))
                    elif t2 == "<Final>":
                        s.read_float()
                    else:
                        raise IOError(f"bad in-state token {t2!r}")
                states.append(st)
            for p in phones:
                topo.entries[p] = states
        return topo

    def topology_for_phone(self, phone: int) -> list[TopologyState]:
        return self.entries[phone]


# ----------------------------------------------------------------------
# TransitionModel
# ----------------------------------------------------------------------

@dataclass
class Tuple4:
    phone: int
    hmm_state: int
    forward_pdf: int
    self_loop_pdf: int


class TransitionModel:
    def __init__(self):
        self.topo = HmmTopology()
        self.tuples: list[Tuple4] = []
        self.log_probs = np.zeros(0, np.float32)
        # derived
        self.state2id = np.zeros(1, np.int64)   # trans-state -> first trans-id
        self.id2state = np.zeros(1, np.int64)
        self.id2pdf = np.zeros(1, np.int64)
        self.num_pdfs = 0

    # -- reading -----------------------------------------------------------
    @staticmethod
    def read(path: str) -> "TransitionModel":
        with open(path, "rb") as f:
            return TransitionModel.read_stream(KaldiStream(f.read()))

    @staticmethod
    def read_stream(s: KaldiStream) -> "TransitionModel":
        tm = TransitionModel()
        s.expect_token("<TransitionModel>")
        tm.topo = HmmTopology.read(s)
        tok = s.read_token()
        if tok not in ("<Triples>", "<Tuples>"):
            raise IOError(f"expected <Triples>/<Tuples>, got {tok!r}")
        four = tok == "<Tuples>"
        n = s.read_int()
        for _ in range(n):
            phone = s.read_int()
            hmm_state = s.read_int()
            pdf = s.read_int()
            pdf2 = s.read_int() if four else pdf
            tm.tuples.append(Tuple4(phone, hmm_state, pdf, pdf2))
        s.expect_token("</Triples>" if not four else "</Tuples>")
        tm._compute_derived()
        tok = s.read_token()
        if tok == "<LogProbs>":
            tm.log_probs = s.read_vector()
            s.expect_token("</LogProbs>")
            tok = s.read_token()
        if tok != "</TransitionModel>":
            raise IOError(f"expected </TransitionModel>, got {tok!r}")
        return tm

    def _compute_derived(self) -> None:
        """ref: TransitionModel::ComputeDerived (transition-model.cc)."""
        nstates = len(self.tuples)
        self.state2id = np.zeros(nstates + 2, np.int64)
        cur = 1  # trans-ids are 1-based
        for ts in range(1, nstates + 1):
            self.state2id[ts] = cur
            tup = self.tuples[ts - 1]
            states = self.topo.topology_for_phone(tup.phone)
            cur += len(states[tup.hmm_state].transitions)
        self.state2id[nstates + 1] = cur
        num_ids = cur - 1
        self.id2state = np.zeros(num_ids + 1, np.int64)
        self.id2pdf = np.zeros(num_ids + 1, np.int64)
        for ts in range(1, nstates + 1):
            tup = self.tuples[ts - 1]
            states = self.topo.topology_for_phone(tup.phone)
            for i, (dst, _p) in enumerate(
                    states[tup.hmm_state].transitions):
                tid = self.state2id[ts] + i
                self.id2state[tid] = ts
                # self-loop transition scores the self-loop pdf
                is_self = dst == tup.hmm_state
                self.id2pdf[tid] = (tup.self_loop_pdf if is_self
                                    else tup.forward_pdf)
        self.num_pdfs = 1 + max(
            max(t.forward_pdf for t in self.tuples),
            max(t.self_loop_pdf for t in self.tuples)) if self.tuples else 0

    # -- queries (ref: transition-model.h:11-106) ---------------------------
    @property
    def num_transition_ids(self) -> int:
        return len(self.id2state) - 1

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.id2pdf[tid])

    def transition_id_to_phone(self, tid: int) -> int:
        return self.tuples[int(self.id2state[tid]) - 1].phone

    def transition_id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[int(self.id2state[tid]) - 1].hmm_state

    def self_loop_of(self, trans_state: int) -> int:
        """trans-id of the self-loop of a transition state, or 0."""
        tup = self.tuples[trans_state - 1]
        states = self.topo.topology_for_phone(tup.phone)
        for i, (dst, _p) in enumerate(states[tup.hmm_state].transitions):
            if dst == tup.hmm_state:
                return int(self.state2id[trans_state]) + i
        return 0

    def ilabel_map(self, ctc_blank_shift: bool = False) -> np.ndarray:
        """Dense ilabel→pdf map for the search kernel: index 0 unused.

        With ``ctc_blank_shift`` pdf-ids are shifted +1 (the reference's
        ExchangePdfId for CTC blank-row-0 models)."""
        m = self.id2pdf.copy()
        if ctc_blank_shift:
            m = m + 1
        m[0] = 0
        return m.astype(np.int32)

    def write_text(self, path: str) -> None:
        """Text writer (round-trip testing; mirrors ref Write)."""
        with open(path, "w") as f:
            f.write("<TransitionModel> \n<Topology> \n")
            written = set()
            for phone, states in self.topo.entries.items():
                key = id(states)
                if key in written:
                    continue
                written.add(key)
                phones = [p for p, st in self.topo.entries.items()
                          if id(st) == key]
                f.write("<TopologyEntry> \n<ForPhones> \n")
                f.write(" ".join(str(p) for p in phones) + " \n")
                f.write("</ForPhones> \n")
                for i, st in enumerate(states):
                    f.write(f"<State> {i} ")
                    if st.pdf_class >= 0:
                        if st.pdf_class == st.self_loop_pdf_class:
                            f.write(f"<PdfClass> {st.pdf_class} ")
                        else:
                            f.write(f"<ForwardPdfClass> {st.pdf_class} "
                                    f"<SelfLoopPdfClass> "
                                    f"{st.self_loop_pdf_class} ")
                    for dst, p in st.transitions:
                        f.write(f"<Transition> {dst} {p} ")
                    f.write("</State> \n")
                f.write("</TopologyEntry> \n")
            f.write("</Topology> \n")
            four = any(t.forward_pdf != t.self_loop_pdf for t in self.tuples)
            tag = "Tuples" if four else "Triples"
            f.write(f"<{tag}> {len(self.tuples)} \n")
            for t in self.tuples:
                if four:
                    f.write(f"{t.phone} {t.hmm_state} {t.forward_pdf} "
                            f"{t.self_loop_pdf}\n")
                else:
                    f.write(f"{t.phone} {t.hmm_state} {t.forward_pdf}\n")
            f.write(f"</{tag}> \n")
            if len(self.log_probs):
                f.write("<LogProbs> \n [ ")
                f.write(" ".join(f"{v:g}" for v in self.log_probs))
                f.write(" ]\n</LogProbs> \n")
            f.write("</TransitionModel> \n")
