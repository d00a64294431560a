"""Model-based (nnet) voice activity detection in PyTorch.

Port of ``asr_decoder_tpu/vad/model_vad.py`` (ref: the online-vad family —
the nnet VAD that runs a small acoustic model on the shared feature stream
and smooths its per-frame silence probability into SIL/AUDIO segments,
src/online-vad/online-vad.h:862 ``VadNnet3``, :794
``VadNnetSimpleLoopedComputationOptions``, :345 ``VadJudge``; and the
segment post-ops ``CompressAlignVad`` / ``MergeSameAduio`` /
``CompressAlignVadAndRestrictMaxNosilFrame``, online-vad.h:170-232).

The VAD nnet is the port's ``Nnet`` run through ``am_forward`` on its
device, the probability→class map is a tensor op there, and the
hysteresis smoother is ``vad/energy.py:smooth_judge`` (window sums on the
device, the FSM on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.models.nnet import Nnet, am_forward
from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.vad.energy import (AUDIO, SIL, EnergyVadConfig,
                                              merge_short_sil, smooth_judge,
                                              vad_segments)


@dataclass
class VadJudgeConfig:
    """Smoothing knobs (ref: VadJudgeOptions, online-vad.h:28-133) reusing
    the energy-VAD window smoother; prefix-scoped registration mirrors the
    reference's ``--nnet-vad-judge.*`` sub-configs."""
    sil2audio_ratio: float = flag(0.5, "Small-window ratio to enter AUDIO")
    audio2sil_ratio: float = flag(0.8, "Big-window ratio to leave AUDIO")
    left_frames: int = flag(5, "Left context frames (big window)")
    right_frames: int = flag(5, "Right lookahead frames")
    sil_prob_threshold: float = flag(
        0.5, "Frame is speech when P(sil) < this")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    def to_energy_cfg(self) -> EnergyVadConfig:
        return EnergyVadConfig(
            sil2audio_ratio=self.sil2audio_ratio,
            audio2sil_ratio=self.audio2sil_ratio,
            left_frames=self.left_frames, right_frames=self.right_frames)


class VadNnet:
    """Silence probability from a VAD nnet on ``device`` (ref: VadNnet3,
    online-vad.h:862): the model's output posteriors are summed over the
    silence rows; everything else counts as speech."""

    def __init__(self, nnet: Nnet, sil_pdfs: list[int] | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.nnet = nnet.to(self.device)
        self.sil_pdfs = torch.as_tensor(
            np.asarray(sil_pdfs if sil_pdfs is not None else [0], np.int64),
            device=self.device)
        layers = list(self.nnet.layers)
        if layers and layers[0].kind == "splice":
            self.splice_offsets = layers[0].meta
            self.layers = layers[1:]
        else:
            self.splice_offsets = None
            self.layers = layers

    def init_state(self, batch: int) -> list[dict]:
        return [l.init_state(batch, self.device) for l in self.layers]

    @torch.inference_mode()
    def sil_prob(self, feats, state):
        """feats f32[B,T,D] (already spliced; array or tensor) →
        (P(sil) f32[B,T] on the device, state')."""
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        post, state = am_forward(self.layers, feats, state,
                                 do_softmax=True, do_log=False,
                                 sub_prior=False)
        return post[..., self.sil_pdfs].sum(dim=-1), state


class VadNnetStream:
    """Streaming model VAD over feature chunks (ref: the VadNnet3 +
    VadJudge pipeline fed from the shared feature stream,
    online-vad.h:862-1050).  ``accept(feats, end)`` returns newly-judged
    SIL/AUDIO decisions (host i32), one per input frame."""

    def __init__(self, vad: VadNnet, judge: VadJudgeConfig, batch: int = 1):
        self.vad = vad
        self.judge = judge
        self._ecfg = judge.to_energy_cfg()
        self.batch = batch
        self.reset()

    def reset(self, keep_flag: bool = False) -> None:
        if not keep_flag:
            self._flag = np.zeros(self.batch, np.int32)
        self._state = self.vad.init_state(self.batch)
        self._class_cache: torch.Tensor | None = None
        self.sil_frames = 0
        self.nosil_frames = 0

    @torch.inference_mode()
    def accept(self, feats: np.ndarray, end: bool = False) -> np.ndarray:
        cfg = self._ecfg
        dev = self.vad.device
        feats = np.asarray(feats, np.float32)
        if feats.shape[1]:
            prob, self._state = self.vad.sil_prob(feats, self._state)
            # speech scores like high energy
            cls = (prob < self.judge.sil_prob_threshold).int() * 2
        else:
            cls = torch.zeros((self.batch, 0), dtype=torch.int32, device=dev)
        if self._class_cache is None:
            if cls.shape[1] == 0 and not end:
                return np.zeros((self.batch, 0), np.int32)
            first = cls[:, :1] if cls.shape[1] else torch.zeros(
                (self.batch, 1), dtype=torch.int32, device=dev)
            self._class_cache = first.repeat(1, cfg.left_frames + 1)
            cls = cls[:, 1:]
        buf = torch.cat([self._class_cache, cls], dim=1)
        if end and buf.shape[1] > 0:
            buf = torch.cat([buf, buf[:, -1:].repeat(1, cfg.right_frames)],
                            dim=1)
        decisions, self._flag = smooth_judge(cfg, buf, self._flag)
        self._class_cache = buf[:, decisions.shape[1]:] if not end else None
        self.nosil_frames += int(decisions.sum())
        self.sil_frames += int(decisions.size - decisions.sum())
        return decisions


# ----------------------------------------------------------------------
# segment post-ops (ref: online-vad.h:170-232)
# ----------------------------------------------------------------------

def compress_align_vad(segs: list[tuple[int, int, int]],
                       sil_frames_cut: int) -> list[tuple[int, int, int]]:
    """Trim long internal silences down to ``sil_frames_cut`` frames,
    keeping edges adjacent to AUDIO (ref: CompressAlignVad,
    online-vad.h:170-213 and --sil-frames-cut)."""
    out: list[tuple[int, int, int]] = []
    for i, (flag, beg, end) in enumerate(segs):
        if flag == SIL and end - beg > sil_frames_cut:
            keep_l = sil_frames_cut // 2
            keep_r = sil_frames_cut - keep_l
            if i == 0:
                out.append((SIL, end - keep_r - keep_l, end))
                continue
            if i == len(segs) - 1:
                out.append((SIL, beg, beg + sil_frames_cut))
                continue
            out.append((SIL, beg, beg + keep_l))
            out.append((SIL, end - keep_r, end))
        else:
            out.append((flag, beg, end))
    return out


def merge_same_audio(segs: list[tuple[int, int, int]],
                     min_sil_frames: int) -> list[tuple[int, int, int]]:
    """Flip short SIL runs between AUDIO runs and merge
    (ref: MergeSameAduio, online-vad.h:214-232): the energy module's
    ``merge_short_sil``."""
    return merge_short_sil(segs, min_sil_frames)


def restrict_max_nosil(segs: list[tuple[int, int, int]],
                       max_nosil_frames: int) -> list[tuple[int, int, int]]:
    """Split AUDIO runs longer than ``max_nosil_frames``
    (ref: CompressAlignVadAndRestrictMaxNosilFrame, online-vad.h:232-345):
    bounds decoder segment length so search state stays bounded."""
    out: list[tuple[int, int, int]] = []
    for flag, beg, end in segs:
        if flag == AUDIO:
            while end - beg > max_nosil_frames:
                out.append((AUDIO, beg, beg + max_nosil_frames))
                beg += max_nosil_frames
        out.append((flag, beg, end))
    return [s for s in out if s[2] > s[1]]


def decisions_to_segments(decisions: np.ndarray) \
        -> list[tuple[int, int, int]]:
    """Per-frame decisions → (flag, beg, end) runs (re-export for callers
    that only import model_vad)."""
    return vad_segments(decisions)
