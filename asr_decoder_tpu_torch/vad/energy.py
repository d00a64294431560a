"""Energy-based voice activity detection in PyTorch.

Port of ``asr_decoder_tpu/vad/energy.py`` (ref: ``EnergyVad``,
src/vad/energy-vad.h:32-449, and the VadJudge smoothing family,
src/online-vad/online-vad.h:28-345): per-frame energy (RMS or mean-abs) →
3-way threshold classification (0/1/2 at thresholds th1/th2) → dual
sliding-window hysteresis smoothing (small window for sil→audio with ratio
0.5, big window for audio→sil with ratio 0.8) → per-frame SIL/AUDIO
decisions → compressed segments (``VadSeg``).

Energies, classes and the window sums are tensor ops on the wave's device.
The hysteresis FSM runs on the host: it is a dependent step per judged
frame (a few tens a push), whose decisions leave the device every push
anyway (the session counts trailing silence from them), so one copy of the
window tests costs less than a launch or more per frame on the card.
Decisions are host ``np.int32`` arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag

SIL, AUDIO = 0, 1


@dataclass
class EnergyVadConfig:
    sample_rate: int = flag(16000, "Waveform sample rate")
    frame_length_s: float = flag(0.025, "VAD frame length (s)")
    frame_shift_s: float = flag(0.010, "VAD frame shift (s)")
    sil2audio_ratio: float = flag(0.5, "Small-window ratio to enter AUDIO")
    audio2sil_ratio: float = flag(0.8, "Big-window ratio to leave AUDIO")
    left_frames: int = flag(5, "Left context frames (big window)")
    right_frames: int = flag(5, "Right lookahead frames")
    energy_threshold1: float = flag(32768 * 0.01, "Low energy threshold")
    energy_threshold2: float = flag(32768 * 0.1, "High energy threshold")
    cal_method: str = flag("sum_square_root", "sum_square_root|sum_abs")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def frame_length_samp(self) -> int:
        return int(self.sample_rate * self.frame_length_s)

    @property
    def frame_shift_samp(self) -> int:
        return int(self.sample_rate * self.frame_shift_s)

    @property
    def sil_left_frames(self) -> int:
        return int(self.left_frames * 0.5)


def frame_energy(cfg: EnergyVadConfig, wave, device=None) -> torch.Tensor:
    """wave f32[B,N] (array or tensor) → per-frame energy f32[B,T] on
    ``device`` (default: the wave's) (ref: OneFrameEnergy,
    energy-vad.h:74-99)."""
    wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
    L, S = cfg.frame_length_samp, cfg.frame_shift_samp
    T = (wave.shape[1] - L + S) // S
    if T <= 0:
        return torch.zeros((wave.shape[0], 0), device=wave.device)
    idx = (torch.arange(T, device=wave.device)[:, None] * S
           + torch.arange(L, device=wave.device)[None, :])
    frames = wave[:, idx]
    if cfg.cal_method == "sum_abs":
        return frames.abs().mean(dim=-1)
    return frames.square().mean(dim=-1).sqrt()


def classify_energy(cfg: EnergyVadConfig, energy: torch.Tensor
                    ) -> torch.Tensor:
    """energy [B,T] → 3-way class i32[B,T] ∈ {0,1,2}
    (ref: JudgeFramesFromEnergy thresholds, energy-vad.h:133-139)."""
    return ((energy >= cfg.energy_threshold1).int()
            + (energy >= cfg.energy_threshold2).int())


def smooth_judge(cfg: EnergyVadConfig, classes: torch.Tensor,
                 init_flag: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Hysteresis smoothing (ref: energy-vad.h:158-223).

    ``classes`` i32[B,T] (on any device) must already include the left/right
    context padding (replicated edges); returns host SIL/AUDIO decisions
    i32[B, T - left - right] and the final FSM flag i32[B] for streaming
    continuation.  The window sums and their threshold tests run on the
    classes' device; the FSM walks the judged frames on the host.
    """
    L, R, SL = cfg.left_frames, cfg.right_frames, cfg.sil_left_frames
    big_n = L + R + 1
    small_n = SL + R + 1
    B, Tp = classes.shape
    T = Tp - L - R
    state = (np.zeros(B, np.int32) if init_flag is None
             else np.asarray(init_flag, np.int32).copy())
    if T <= 0:
        return np.zeros((B, 0), np.int32), state
    cs = torch.nn.functional.pad(torch.cumsum(classes, dim=1), (1, 0))
    pos = torch.arange(L + R, Tp, device=classes.device)
    big_sum = cs[:, pos + 1] - cs[:, pos + 1 - big_n]
    small_sum = cs[:, pos + 1] - cs[:, pos + 1 - small_n]
    # the JAX step compares the int32 sums with the thresholds in float32
    enter, stay = torch.stack([
        small_sum.float() > small_n * cfg.sil2audio_ratio,
        big_sum.float() > big_n * (1.0 - cfg.audio2sil_ratio)]).cpu().numpy()
    decisions = np.empty((B, T), np.int32)
    for t in range(T):
        state = np.where(state == SIL, enter[:, t], stay[:, t]).astype(
            np.int32)
        decisions[:, t] = state
    return decisions, state


def vad_segments(decisions: np.ndarray) -> list[tuple[int, int, int]]:
    """Per-frame decisions [T] → [(flag, beg, end)] runs
    (ref: CompressVadRes / VadSeg, energy-vad.h:232-268)."""
    decisions = np.asarray(decisions)
    segs: list[tuple[int, int, int]] = []
    if len(decisions) == 0:
        return segs
    beg = 0
    cur = int(decisions[0])
    for i in range(1, len(decisions)):
        d = int(decisions[i])
        if d != cur:
            segs.append((cur, beg, i))
            beg, cur = i, d
    segs.append((cur, beg, len(decisions)))
    return segs


def merge_short_sil(segs, min_sil_frames: int):
    """Merge AUDIO runs separated by short silences
    (ref: MergeSameAduio / min-sil-frames-interval,
    online-vad/online-vad.h:214-232)."""
    merged: list[tuple[int, int, int]] = []
    for i, seg in enumerate(segs):
        if (seg[0] == SIL and 0 < i < len(segs) - 1
                and segs[i - 1][0] == AUDIO and segs[i + 1][0] == AUDIO
                and seg[2] - seg[1] < min_sil_frames):
            seg = (AUDIO, seg[1], seg[2])
        if merged and merged[-1][0] == seg[0]:
            merged[-1] = (seg[0], merged[-1][1], seg[2])
        else:
            merged.append(seg)
    return merged


class EnergyVadStream:
    """Streaming energy VAD over waveform chunks (single stream or batch).

    Keeps the reference's caches: sample remainder (host), padded class
    history for window context (on ``device``), and the hysteresis flag
    (host) (ref: energy-vad.h FramesEnergy data cache :103-125 and
    first/last-frame padding :137-156).
    """

    def __init__(self, cfg: EnergyVadConfig, batch: int = 1,
                 device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.device = torch.device(device)
        self.reset()

    def reset(self, keep_flag: bool = False) -> None:
        if not keep_flag:
            self._flag = np.zeros(self.batch, np.int32)
        self._wave_cache = np.zeros((self.batch, 0), np.float32)
        self._class_cache: torch.Tensor | None = None  # padded, not judged
        self.sil_frames = 0
        self.nosil_frames = 0

    @torch.inference_mode()
    def accept(self, wave: np.ndarray, end: bool = False) -> np.ndarray:
        """wave f32[B, n] chunk → new decisions i32[B, t] (host)."""
        cfg = self.cfg
        wave = np.concatenate(
            [self._wave_cache, np.asarray(wave, np.float32)], axis=1)
        L, S = cfg.frame_length_samp, cfg.frame_shift_samp
        T = max(0, (wave.shape[1] - L + S) // S)
        if T > 0:
            cls = classify_energy(cfg, frame_energy(
                cfg, wave[:, :(T - 1) * S + L], self.device))
            self._wave_cache = wave[:, T * S:]
        else:
            cls = torch.zeros((self.batch, 0), dtype=torch.int32,
                              device=self.device)
            self._wave_cache = wave
        if self._class_cache is None:
            if cls.shape[1] == 0 and not end:
                return np.zeros((self.batch, 0), np.int32)
            first = cls[:, :1] if cls.shape[1] else torch.zeros(
                (self.batch, 1), dtype=torch.int32, device=self.device)
            self._class_cache = first.repeat(1, cfg.left_frames + 1)
            cls = cls[:, 1:]
        buf = torch.cat([self._class_cache, cls], dim=1)
        if end and buf.shape[1] > 0:
            buf = torch.cat([buf, buf[:, -1:].repeat(1, cfg.right_frames)],
                            dim=1)
        decisions, self._flag = smooth_judge(cfg, buf, self._flag)
        n = decisions.shape[1]
        self._class_cache = buf[:, n:] if not end else None
        self.nosil_frames += int(decisions.sum())
        self.sil_frames += int(decisions.size - decisions.sum())
        return decisions
