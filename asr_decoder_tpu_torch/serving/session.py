"""Streaming decode sessions (the v2 session API) in PyTorch.

Port of ``asr_decoder_tpu/serving/session.py`` (ref:
``OnlineClgLatticeFastDecoder``, src/kaldi-nnet3/kaldi-online-nnet3-my-
decoder.h:233-344, and the VAD orchestration of ``V1AsrWorker``,
src/v1-asr/kaldi-v1-asr-online.h:235): chunked 16-bit PCM in → features
(fbank, optionally ‖ pitch and deltas) → AM posteriors → beam search →
partial/final text, n-best, lattice; endpoint detection from the energy
VAD's trailing silence (``use_energy_vad``); mid-stream re-initialisation
after an endpoint (``init_decoding``, ref ``InitDecoding(frame_offset)``,
kaldi-online-nnet3-my-decoder.h:301-324).

A session is the one-channel view of the arena
(``serving/batcher.py:BatchedStreamingDecoder``): the port streams by one
rule in one place.  This module holds what both share: the configs, the
``FeatureBuffer``, the model state (``OnlineDecoderInfo``) and the host
helpers that turn a channel's logs into results.

All three graph types are ported: ``hclg`` (``TorchBeamSearch``), ``clg``
(``TorchClgBeamSearch``) and ``biglm-hclg`` (``TorchBigLmBeamSearch``).
Their tracebacks and lattices take different arguments, so the helpers
below dispatch on the graph type.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.determinize import (DeterminizeError,
                                                   determinize_lattice)
from asr_decoder_tpu_torch.fst import native_nbest
from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
from asr_decoder_tpu_torch.fst.fst import StdFst
from asr_decoder_tpu_torch.fst.nbest import nshortest
from asr_decoder_tpu_torch.fst.symbol import SymbolTable
from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.frontend.fbank import CmvnConfig, FbankConfig
from asr_decoder_tpu_torch.frontend.pipeline import StreamingFrontend
from asr_decoder_tpu_torch.frontend.pitch import ProcessPitchConfig
from asr_decoder_tpu_torch.models.nnet import (AmConfig, GraphedAm, Nnet,
                                               blank_frame_mask)
from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
from asr_decoder_tpu_torch.ops.beamsearch_biglm import TorchBigLmBeamSearch
from asr_decoder_tpu_torch.ops.beamsearch_clg import TorchClgBeamSearch
from asr_decoder_tpu_torch.vad.energy import EnergyVadConfig, EnergyVadStream


@dataclass
class OnlineDecoderConfig:
    """Session flags (ref: OnlineDecoderConf,
    kaldi-online-nnet3-my-decoder.h:22-83)."""
    graph_type: str = flag("hclg", "hclg|clg|biglm-hclg")
    chunk_frames: int = flag(32, "AM/search frames per device dispatch")
    use_energy_vad: bool = flag(False, "Gate frames through energy VAD")
    endpoint_sil_frames: int = flag(
        50, "Trailing silence frames that trigger an endpoint")
    min_endpoint_frames: int = flag(
        30, "Never endpoint before this many decoded frames")
    ctc_blank_shift: bool = flag(
        False, "ilabel→pdf is ilabel-1 (CTC) instead of transition-id→pdf")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class FeatureBuffer:
    """Streaming feature buffer with left/right context padding (the
    ``DnnFeat`` role, ref: src/nnet/nnet-feature-api.h:10-74): pads left
    context by repeating the first frame, holds back ``right`` frames until
    they have full future context (repeat-pads at EOS), splices, and emits
    each frame exactly once — so stateful layers never see a frame twice."""

    def __init__(self, left: int, right: int, offsets: tuple[int, ...] | None):
        self.left = left
        self.right = right
        self.offsets = offsets  # None: no splice layer, emit raw frames
        self.reset()

    def reset(self) -> None:
        self._buf: np.ndarray | None = None   # [t, D] incl. left padding
        self._next = 0                        # next frame index to emit

    def accept(self, feats: np.ndarray, end: bool = False) -> np.ndarray:
        """feats f32[t, D] new frames → spliced frames ready to score."""
        feats = np.asarray(feats, np.float32)
        if self._buf is None:
            if feats.shape[0] == 0:
                return feats.reshape(0, feats.shape[1] if feats.ndim > 1 else 0)
            pad = np.repeat(feats[:1], self.left, axis=0)
            self._buf = np.concatenate([pad, feats], axis=0)
            self._next = self.left
        elif feats.shape[0]:
            self._buf = np.concatenate([self._buf, feats], axis=0)
        buf = self._buf
        if end:
            stop = len(buf)
            if stop > self._next and self.right:
                buf = np.concatenate(
                    [buf, np.repeat(buf[-1:], self.right, axis=0)], axis=0)
        else:
            stop = len(buf) - self.right
        if stop <= self._next:
            return np.zeros((0, buf.shape[1]), np.float32)
        rows = np.arange(self._next, stop)
        self._next = stop
        if self.offsets is None:
            return buf[rows]
        idx = rows[:, None] + np.asarray(self.offsets)[None, :]
        idx = np.clip(idx, 0, len(buf) - 1)
        return buf[idx].reshape(len(rows), -1)


class OnlineDecoderInfo:
    """Shared read-only model state, one per server process (ref:
    OnlineDecoderInfo, kaldi-online-nnet3-my-decoder.h:85-231): AM, graph,
    search engine, symbol table, configs — all on ``device``.

    ``graph_type`` (OnlineDecoderConfig) picks the decoder variant (ref
    decoder selection hclg|clg|biglm-hclg, kaldi-online-nnet3-my-
    decoder.h:250-284):

      * ``hclg``       — the pre-composed graph ``fst``;
      * ``clg``        — the on-the-fly CLG⊗HMM composite ``clg_graph``
        (shared ``fst/clg.py`` ClgFst); ``fst`` is None, so no word
        alignment;
      * ``biglm-hclg`` — ``fst`` plus ``difflm`` (``lm/device_lm.py``
        DeviceDiffLm, its tables on ``device``): in-search
        difference-LM rescoring.

    ``vad_config`` sets the energy VAD that ``use_energy_vad`` turns on;
    ``pitch_config`` (with ``process_pitch_config``, defaulted when None)
    appends Kaldi pitch to the fbank features (the ``DnnPitchFeat`` stack,
    ref: src/nnet/nnet-feature-api.h:86-185).
    """

    def __init__(self, nnet: Nnet, fst: StdFst | None, words: SymbolTable,
                 ilabel2pdf: np.ndarray,
                 decoder_config: DecoderConfig | None = None,
                 online_config: OnlineDecoderConfig | None = None,
                 fbank_config: FbankConfig | None = None,
                 am_config: AmConfig | None = None,
                 cmvn_config: CmvnConfig | None = None,
                 delta_config=None, clg_graph=None, difflm=None,
                 vad_config: EnergyVadConfig | None = None,
                 pitch_config=None, process_pitch_config=None, *, device):
        self.device = torch.device(device)
        self.config = online_config or OnlineDecoderConfig()
        self.decoder_config = decoder_config or DecoderConfig()
        gt = self.config.graph_type
        lanes = self.decoder_config.arc_lanes
        if gt == "hclg":
            if fst is None:
                raise ValueError("hclg graph type needs fst")
            self.search = TorchBeamSearch(
                DeviceFst.build(fst, arc_lanes=lanes), ilabel2pdf,
                self.decoder_config, device=self.device)
        elif gt == "clg":
            if clg_graph is None:
                raise ValueError("clg graph type needs clg_graph")
            self.search = TorchClgBeamSearch(clg_graph, ilabel2pdf,
                                             self.decoder_config,
                                             device=self.device)
        elif gt == "biglm-hclg":
            if fst is None or difflm is None:
                raise ValueError("biglm-hclg graph type needs fst and difflm")
            self.search = TorchBigLmBeamSearch(
                DeviceFst.build(fst, arc_lanes=lanes), ilabel2pdf, difflm,
                self.decoder_config, device=self.device)
        else:
            raise ValueError(f"unknown graph_type {gt!r}")
        self.nnet = nnet.to(self.device)
        self.fst = fst
        self.words = words
        self.fbank_config = fbank_config or FbankConfig()
        self.am_config = am_config or AmConfig()
        self.cmvn_config = cmvn_config  # None = no live CMVN
        self.delta_config = delta_config
        self.vad_config = vad_config or EnergyVadConfig()
        self.pitch_config = pitch_config
        self.process_pitch_config = process_pitch_config
        if pitch_config is not None and process_pitch_config is None:
            self.process_pitch_config = ProcessPitchConfig()
        if self.am_config.skip_copy and self.am_config.skip:
            assert self.config.chunk_frames % (self.am_config.skip + 1) == 0, \
                "skip_copy needs chunk_frames divisible by skip+1 (chunks " \
                "must stay phase-aligned)"
        self.ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
        # a leading splice layer is applied by the FeatureBuffer
        layers = list(self.nnet.layers)
        if layers and layers[0].kind == "splice":
            self.splice_offsets = layers[0].meta
            self.am_layers = layers[1:]
        else:
            self.splice_offsets = None
            self.am_layers = layers
        self.left, self.right = self.nnet.context()
        self._am_graphs: dict[tuple, GraphedAm] = {}

    @property
    def seconds_per_frame(self) -> float:
        """Wall seconds per *scored* frame (frame shift × subsampling when
        plain ``skip`` drops frames before the search)."""
        spf = self.fbank_config.frame_shift_ms / 1000.0
        if self.am_config.skip and not self.am_config.skip_copy:
            spf *= self.am_config.skip + 1
        return spf

    def make_frontend(self, batch: int = 1) -> StreamingFrontend:
        """Streaming frontend for one session/channel: fbank (+CMVN)
        (‖ pitch) (+ deltas) on this info's device."""
        return StreamingFrontend(self.fbank_config, batch=batch,
                                 pitch_cfg=self.pitch_config,
                                 ppitch_cfg=self.process_pitch_config,
                                 delta_cfg=self.delta_config,
                                 cmvn_cfg=self.cmvn_config,
                                 device=self.device)

    def make_vad(self) -> EnergyVadStream | None:
        """The energy VAD of one session/channel, or None without
        ``use_energy_vad``."""
        if not self.config.use_energy_vad:
            return None
        return EnergyVadStream(self.vad_config, batch=1, device=self.device)

    def endpoint(self, frames_decoded: int, trailing_sil: int) -> bool:
        """The endpoint rule (ref: EndpointDetected,
        kaldi-online-nnet3-my-decoder.h:344): enough frames decoded and
        enough trailing silence."""
        cfg = self.config
        return (frames_decoded >= cfg.min_endpoint_frames
                and trailing_sil >= cfg.endpoint_sil_frames)

    def score(self, feats: torch.Tensor, am_state, valid: np.ndarray,
              layers=None):
        """One chunk through the AM (``am_layers``, or their replica
        ``layers`` on another device): feats f32[B, C, D] on the layers'
        device, ``valid`` host i32[B] real frames per row → (loglikes [B,
        C', V], new AM state, host frame mask bool[B, C']).  The chunk runs
        through a ``GraphedAm`` of the layer list (one replay of a captured
        graph on a card), so it must run without autograd."""
        ac = self.am_config
        layers = self.am_layers if layers is None else layers
        # one GraphedAm a layer list (it holds the layers, so the ids stay
        # theirs while it is cached)
        key = tuple(id(l) for l in layers)
        if key not in self._am_graphs:
            self._am_graphs[key] = GraphedAm(layers)
        # skip_copy mode subsamples + score-copies inside am_forward; each
        # chunk is phase-aligned (chunk_frames % (skip+1) == 0)
        loglikes, am_state = self._am_graphs[key](
            feats, am_state, do_softmax=ac.do_softmax, do_log=ac.do_log,
            sub_prior=ac.sub_prior, block_pdf_pdfid=ac.block_pdf_pdfid,
            block_scale=ac.block_scale, skip_block=ac.skip_block,
            skip=ac.skip if ac.skip_copy else 0, skip_copy=ac.skip_copy)
        mask = np.arange(feats.shape[1])[None, :] < valid[:, None]
        if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
            # CTC blank-skip (ref SkipBlockFrame, nnet-nnet.h:265-275)
            mask &= ~blank_frame_mask(loglikes, ac.block_pdf_pdfid,
                                      ac.acoustic_scale).cpu().numpy()
        return loglikes, am_state, mask


def empty_path() -> dict:
    """The best path of an utterance with no frames decoded."""
    return dict(arc_ids=[], cost=0.0, words=[], ilabels=[],
                reached_final=False)


def best_path(info: OnlineDecoderInfo, beam, init_log, chunk_logs) -> dict:
    """Best path of one utterance from host logs: the CLG traceback takes
    no graph (and gives no arc ids), the others read words off ``fst``."""
    if not chunk_logs:
        return empty_path()
    if info.config.graph_type == "clg":
        return info.search.traceback(beam, init_log, chunk_logs)[0]
    return info.search.traceback(beam, init_log, chunk_logs, info.fst)[0]


def word_alignment(info: OnlineDecoderInfo, best: dict,
                   frame_offset: int = 0) -> list[tuple[str, float, float]]:
    """Per-word time spans [(word, begin_s, end_s)] of a best path (ref:
    AlignTime, net-data-package.h:210); needs the arc-labelled ``fst``."""
    from asr_decoder_tpu_torch.align.word_align import (spans_to_align,
                                                        word_spans)
    fst = info.fst
    if fst is None:
        raise RuntimeError("word alignment needs an arc-labeled StdFst "
                           "graph (hclg/biglm-hclg)")
    spans = word_spans(best.get("arc_ids", []), fst.arc_ilabel,
                       fst.arc_olabel, frame_offset,
                       anchor=getattr(fst, "olabel_anchor", "start"))
    return spans_to_align(spans, info.words, info.seconds_per_frame)


def lattice_from_logs(info: OnlineDecoderInfo, init_log, logs, lls,
                      determinize: bool):
    """Raw (or determinized) lattice from host logs of one utterance."""
    ac = info.am_config
    if ac.skip_blank_frames and ac.block_pdf_pdfid >= 0:
        raise RuntimeError(
            "lattice output is unsupported with skip_blank_frames (CTC "
            "blank-skip is a best-path fast path; the reference likewise "
            "uses SkipBlockFrame only in best-path CTC decoders)")
    mask = np.ones(lls.shape[:2], bool)
    if info.config.graph_type == "clg":
        lat = info.search.get_lattices(init_log, logs, lls,
                                       frame_mask=mask)[0]
    else:   # hclg / biglm-hclg share the StdFst-keyed signature
        lat = info.search.get_lattices(init_log, logs, lls, info.fst,
                                       frame_mask=mask)[0]
    if lat is not None and determinize and lat.num_states:
        try:
            lat = determinize_lattice(lat)
        except DeterminizeError:
            pass  # raw lattice fallback (acyclic by construction)
    return lat


def nbest_from_lattice(info: OnlineDecoderInfo, lat, n: int) -> list[dict]:
    """n-best word sequences of a lattice: the native C++ n-shortest when a
    toolchain exists (``fst/native_nbest.py``, exact parity with the Python
    path), else the Python one — which then skips serializing the
    lattice."""
    if lat is None or not lat.num_states:
        return []
    if native_nbest.available():
        return [dict(words=r["words"],
                     text=" ".join(info.words.words(r["words"])),
                     graph_cost=r["graph_cost"], am_cost=r["am_cost"])
                for r in native_nbest.nshortest_bytes(lat.to_bytes(), n)]
    out = []
    for p in nshortest(lat, n):
        words = [a.olabel for a in p.arcs if a.olabel != 0]
        out.append(dict(words=words, text=" ".join(info.words.words(words)),
                        graph_cost=p.graph_cost, am_cost=p.am_cost))
    return out


def merge_logs(chunk_logs: list):
    """Concatenate host per-chunk logs along the frame axis (every leaf of
    every search's log has the frame axis first)."""
    if not chunk_logs:
        return None
    return type(chunk_logs[0])(*(
        np.concatenate([c[i] for c in chunk_logs], axis=0)
        for i in range(len(chunk_logs[0]))))


def trailing_silence(vad: EnergyVadStream | None, pcm: np.ndarray,
                     eos: bool, prev: int) -> int:
    """Push ``pcm`` f32[1, n] through ``vad`` and return the stream's
    trailing SIL frame count: ``prev`` plus this push's decisions when they
    are all silence, else the silence after its last AUDIO frame."""
    if vad is None or not pcm.shape[1]:
        return prev
    decisions = vad.accept(pcm, end=eos)[0]
    audio = np.flatnonzero(decisions)
    if not len(audio):
        return prev + len(decisions)
    return len(decisions) - 1 - int(audio[-1])


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t``."""
    return t.to("cpu", copy=True).numpy()


def host_log(log):
    """A host copy of a search's log (a NamedTuple of tensors)."""
    return type(log)(*(to_host(t) for t in log))


class OnlineDecoderSession:
    """One streaming utterance (ref: OnlineClgLatticeFastDecoder session
    methods ProcessData/GetLattice/GetBestPathTxt/GetNbestTxt/
    EndpointDetected, kaldi-online-nnet3-my-decoder.h:330-344): the one
    channel of a one-channel ``BatchedStreamingDecoder`` on ``info.device``,
    so a session streams by the arena's code."""

    def __init__(self, info: OnlineDecoderInfo):
        from asr_decoder_tpu_torch.serving.batcher import \
            BatchedStreamingDecoder
        self.info = info
        self._arena = BatchedStreamingDecoder(info, 1)
        self._cid = self._arena.acquire()

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Full per-utterance reset (ref: Reset + ResetRnnBuffer): a fresh
        channel."""
        self._arena.release(self._cid)
        self._cid = self._arena.acquire()

    def init_decoding(self) -> None:
        """Restart the search only, keeping feature/AM streaming state —
        the VAD-cut resumption (ref: InitDecoding(frame_offset)).  Frames
        not yet scored stay queued for the next segment, as in the
        arena's ``init_decoding`` (the JAX session drops them, so its
        segments after an endpoint differ from its server's)."""
        self._arena.init_decoding(self._cid)

    @property
    def num_frames_decoded(self) -> int:
        return self._arena.frames_decoded(self._cid)

    # -- streaming input ---------------------------------------------------
    def process_data(self, pcm: np.ndarray, eos: bool = False) -> None:
        """Push a chunk of 16-bit-scale PCM samples f32/int16[n]
        (ref: ProcessData) and decode every full chunk (all at ``eos``,
        after which the session takes no input until ``reset``)."""
        self._arena.push(self._cid, pcm, eos)
        self._arena.drain()

    # -- results -----------------------------------------------------------
    def get_best_path(self) -> dict:
        """Best path so far (partial before EOS) — words, ilabels, cost
        (ref: GetBestPath/GetBestPathTxt)."""
        return self._arena.get_best_path(self._cid)

    def get_best_path_txt(self) -> str:
        return self._arena.get_best_path_txt(self._cid)

    def get_word_alignment(self, frame_offset: int = 0
                           ) -> list[tuple[str, float, float]]:
        """Per-word time spans [(word, begin_s, end_s)] of the best path
        (ref: AlignTime, net-data-package.h:210); raises for ``clg``."""
        return self._arena.get_word_alignment(self._cid, frame_offset)

    def get_lattice(self, determinize: bool = True):
        """Raw (or determinized) lattice of the utterance so far
        (ref: GetLattice; GetRawLattice, online-decoder-base-inl.h:869-977)."""
        return self._arena.get_lattice(self._cid, determinize)

    def get_nbest(self, n: int) -> list[dict]:
        """n-best word sequences with costs (ref: GetNbest/GetNbestTxt)."""
        return self._arena.get_nbest(self._cid, n)

    def get_nbest_txt(self, n: int) -> list[str]:
        return [r["text"] for r in self.get_nbest(n)]

    # -- endpointing --------------------------------------------------------
    def endpoint_detected(self) -> bool:
        """True when trailing silence meets the endpoint rule (ref:
        EndpointDetected, kaldi-online-nnet3-my-decoder.h:344; needs
        use_energy_vad)."""
        return self._arena.endpoint_detected(self._cid)
