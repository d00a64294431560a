"""V1 session: VAD *orchestrates* decoding — silence never reaches the AM.

Port of ``asr_decoder_tpu/serving/v1_session.py``, over the port's
``OnlineDecoderSession`` and ``EnergyVadStream`` on ``info.device`` (ref:
the ``V1AsrWorker`` orchestration, src/v1-asr/kaldi-v1-asr-online.h
:303-657): the VAD segments the PCM
stream into SIL/AUDIO runs; only AUDIO samples are fed to the inner
``OnlineDecoderSession`` (fbank → AM → search), so silence costs zero
device work; a long-enough SIL run (``--sil-frames-cut``) *cuts* the
stream — the current segment is finalized, its result appended, and the
decoder + feature pipeline reset for the next segment (ref
``Init(false, …)`` after each cut, :480-485).  Short SIL gaps are merged
into the surrounding speech (fed through) so words spanning brief pauses
survive.

Two modes (ref ``--use-realtime-vad``):
  * realtime (default): segments are cut as decisions stream in; partial
    results are available per segment;
  * end-compressed: decisions are buffered to EOS, the full alignment is
    compressed (``merge_short_sil`` gap merge + ``restrict_max_nosil``
    splitting, the online-vad post-ops), then segments decode back-to-back
    (ref GetTotalVadAli compress path, :447-456).

Per-segment results carry the *original-stream* frame span
(``_decoder_start_offset`` bookkeeping, ref :620) so word timings survive
the silence cut; ``tot_sil_frames``/``tot_nosil_frames`` feed the
reference's nosil-normalized RTF accounting (ref GetSilAndNosil +
thread-info.h:10-23).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from asr_decoder_tpu_torch.serving.session import (OnlineDecoderInfo,
                                                   OnlineDecoderSession)
from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.vad.energy import EnergyVadStream, vad_segments
from asr_decoder_tpu_torch.vad.model_vad import merge_same_audio, \
    restrict_max_nosil

AUDIO, SIL = 1, 0


@dataclass
class V1AsrConfig:
    """ref: V1AsrOpts (src/v1-asr/kaldi-v1-asr-online.h:200-260)."""
    use_realtime_vad: bool = flag(
        True, "Cut segments as VAD decisions stream in; False buffers to "
              "EOS and decodes the compressed alignment")
    sil_frames_cut: int = flag(
        50, "Continuous SIL frames that cut the stream (finalize + reset)")
    min_sil_frames_interval: int = flag(
        20, "Merge SIL gaps shorter than this into speech")
    max_nosil_frames: int = flag(
        0, "Split AUDIO runs longer than this (0 = off)")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class _SampleBuf:
    """Growing PCM buffer with absolute frame→sample addressing."""

    def __init__(self, shift: int, length: int):
        self.shift = shift
        self.length = length
        self._chunks: list[np.ndarray] = []
        self._n = 0

    def push(self, pcm: np.ndarray) -> None:
        if len(pcm):
            self._chunks.append(np.asarray(pcm, np.float32).ravel())
            self._n += len(pcm)

    def frames(self, f0: int, f1: int, tail: bool = False) -> np.ndarray:
        """Samples of frames [f0, f1): shift-spaced blocks; with ``tail``
        also the analysis-window tail (length-shift samples) so the last
        frame has its full window.  Incremental feeds must pass
        ``tail=False`` — sending the tail on every call would duplicate
        samples into the downstream streaming frontend."""
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        buf = self._chunks[0] if self._chunks else np.zeros(0, np.float32)
        lo = min(f0 * self.shift, len(buf))
        hi = f1 * self.shift + (self.length - self.shift if tail else 0)
        return buf[lo:min(hi, len(buf))]


class V1AsrSession:
    """VAD-orchestrated streaming session (ref V1AsrWorker Process,
    kaldi-v1-asr-online.h:436-657)."""

    def __init__(self, info: OnlineDecoderInfo,
                 v1_config: V1AsrConfig | None = None,
                 vad: EnergyVadStream | None = None):
        self.info = info
        self.config = v1_config or V1AsrConfig()
        self._vad = vad or EnergyVadStream(info.vad_config,
                                           device=info.device)
        self._inner = OnlineDecoderSession(info)
        self._buf = _SampleBuf(info.vad_config.frame_shift_samp,
                               info.vad_config.frame_length_samp)
        self.reset()

    def reset(self) -> None:
        self._vad.reset()
        self._inner.reset()
        self._buf = _SampleBuf(self._buf.shift, self._buf.length)
        self._decisions: list[int] = []
        self._frames_seen = 0
        self._in_speech = False
        self._pending_sil = 0
        self._seg_start = 0          # original-stream frame of segment start
        self._next_feed = 0          # next unfed frame (current segment)
        self.results: list[dict] = []
        self.tot_sil_frames = 0
        self.tot_nosil_frames = 0

    # -- input --------------------------------------------------------------
    def process_data(self, pcm: np.ndarray, eos: bool = False) -> None:
        pcm = np.asarray(pcm, np.float32).ravel()
        self._buf.push(pcm)
        dec = self._vad.accept(pcm[None], end=eos)[0] \
            if (len(pcm) or eos) else np.zeros(0, bool)
        self.tot_nosil_frames += int(dec.sum())
        self.tot_sil_frames += int(len(dec) - dec.sum())
        if self.config.use_realtime_vad:
            self._walk_realtime(dec, eos)
        else:
            self._decisions.extend(int(d) for d in dec)
            if eos:
                self._decode_compressed()

    # -- realtime orchestration ----------------------------------------------
    def _walk_realtime(self, dec: np.ndarray, eos: bool) -> None:
        cfg = self.config
        for d in dec:
            f = self._frames_seen
            self._frames_seen += 1
            if d:
                if not self._in_speech:
                    self._in_speech = True
                    self._seg_start = f
                    self._next_feed = f
                # feed the gap (short merged sil) + this frame
                self._feed(f + 1)
                self._pending_sil = 0
                if (cfg.max_nosil_frames and
                        f + 1 - self._seg_start >= cfg.max_nosil_frames):
                    self._finalize(f + 1)
            elif self._in_speech:
                self._pending_sil += 1
                if self._pending_sil >= cfg.sil_frames_cut:
                    self._finalize(f + 1 - self._pending_sil)
        if eos and self._in_speech:
            self._finalize(self._frames_seen - self._pending_sil)

    def _feed(self, upto: int) -> None:
        if upto > self._next_feed:
            self._inner.process_data(self._buf.frames(self._next_feed, upto))
            self._next_feed = upto

    def _finalize(self, end_frame: int) -> None:
        """AUDIO→SIL cut: feed any unfed frames plus the analysis-window
        tail (exactly once per segment), finalize the inner session, record
        the segment result with its original-stream frame span, reset the
        decoder + feature pipeline but NOT the VAD or totals
        (ref Init(false, …) after a cut, kaldi-v1-asr-online.h:480-485)."""
        self._inner.process_data(
            self._buf.frames(self._next_feed, end_frame, tail=True),
            eos=True)
        self._next_feed = end_frame
        res = self._inner.get_best_path()
        res["text"] = " ".join(self.info.words.words(res.get("words", [])))
        res["frame_span"] = (self._seg_start, end_frame)
        res["frames"] = self._inner.num_frames_decoded
        if self.info.fst is not None:
            # per-word spans within the segment (seconds from segment
            # start; place with frame_span) — the AlignTime result
            # (ref net-data-package.h:210)
            res["align"] = self._inner.get_word_alignment()
        self.results.append(res)
        self._inner.reset()
        self._in_speech = False
        self._pending_sil = 0

    # -- end-compressed orchestration -----------------------------------------
    def _decode_compressed(self) -> None:
        cfg = self.config
        segs = vad_segments(np.array(self._decisions, np.int64))
        segs = merge_same_audio(segs, cfg.min_sil_frames_interval)
        if cfg.max_nosil_frames:
            segs = restrict_max_nosil(segs, cfg.max_nosil_frames)
        for flag_, beg, end in segs:
            if flag_ != AUDIO:
                continue
            self._seg_start = beg
            self._next_feed = beg
            self._in_speech = True
            self._finalize(end)

    # -- results --------------------------------------------------------------
    def partial_text(self) -> str:
        """Finalized segments + the live segment's partial best path
        (ref _best_result accumulation + Decoding, :590-607)."""
        texts = [r["text"] for r in self.results]
        if self._in_speech:
            part = self._inner.get_best_path()
            t = " ".join(self.info.words.words(part.get("words", [])))
            if t:
                texts.append(t)
        return ",".join(t for t in texts if t)

    def result_text(self) -> str:
        return ",".join(r["text"] for r in self.results if r["text"])

    def frames_decoded(self) -> int:
        """Device-side decoded frames across all segments so far — the
        'sil frames skip device work' accounting."""
        done = sum(r.get("frames", 0) for r in self.results)
        return done + self._inner.num_frames_decoded

    def nosil_rtf(self, run_time_s: float) -> float:
        """run-time / nosil-time (ref thread-info.h:10-23 efficiency)."""
        shift_s = self.info.vad_config.frame_shift_s
        nosil_s = max(self.tot_nosil_frames * shift_s, 1e-9)
        return run_time_s / nosil_s
