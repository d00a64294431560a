"""Batched log-mel filterbank (FBANK) frontend in PyTorch.

Port of ``asr_decoder_tpu/frontend/fbank.py`` (ref: src/nnet/
FeatureExtractor.h:14-87, conf src/nnet/fbanks.cfg; Kaldi fbank of
src/v1-asrbin/conf/fbank.80.conf): framing gather, window, ``torch.fft.rfft``
and one [bins × fft] product for a whole batch of waveforms; the streaming
wrapper with sample carry (``ExtractFeat``/``ExtractFeat_Last``) and live /
utterance CMVN.  The numpy helpers (window, mel matrix, frame count) are
the JAX module's, repeated here because that module imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag


@dataclass
class FbankConfig:
    sample_rate: int = flag(16000, "Waveform sample rate")
    frame_length_ms: float = flag(25.0, "Window length (ms)")
    frame_shift_ms: float = flag(10.0, "Frame shift (ms)")
    num_bins: int = flag(40, "Number of mel channels")
    low_freq: float = flag(20.0, "Lowest mel-bank frequency")
    high_freq: float = flag(0.0, "Highest frequency (<=0: nyquist+offset)")
    preemphasis: float = flag(0.97, "Pre-emphasis coefficient")
    dither: float = flag(0.0, "Dither amplitude (0 = deterministic)")
    remove_dc: bool = flag(True, "Subtract per-frame mean")
    window_type: str = flag("povey", "povey|hamming|hanning|rectangular")
    use_power: bool = flag(True, "Power spectrum (else magnitude)")
    use_log: bool = flag(True, "Log of mel energies")
    snip_edges: bool = flag(True, "Only emit fully-contained frames")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.window_size:
            n *= 2
        return n


def _window_fn(cfg: FbankConfig) -> np.ndarray:
    M = cfg.window_size
    a = 2 * np.pi / (M - 1)
    i = np.arange(M)
    if cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(M)
    else:
        raise ValueError(f"unknown window {cfg.window_type!r}")
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Kaldi-style triangular mel filterbank matrix [num_bins, fft//2+1]."""
    nfft = cfg.fft_size
    nyquist = cfg.sample_rate / 2
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_lo = mel_scale(cfg.low_freq)
    mel_hi = mel_scale(high)
    delta = (mel_hi - mel_lo) / (cfg.num_bins + 1)
    fft_freqs = np.arange(nfft // 2 + 1) * (cfg.sample_rate / nfft)
    mel_freqs = mel_scale(fft_freqs)
    banks = np.zeros((cfg.num_bins, nfft // 2 + 1), np.float32)
    for b in range(cfg.num_bins):
        left = mel_lo + b * delta
        center = mel_lo + (b + 1) * delta
        right = mel_lo + (b + 2) * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def num_frames(cfg: FbankConfig, num_samples: int) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.window_size:
            return 0
        return 1 + (num_samples - cfg.window_size) // cfg.window_shift
    return (num_samples + cfg.window_shift // 2) // cfg.window_shift


def compute_fbank(cfg: FbankConfig, wave, device=None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """wave f32[B, N] (16-bit PCM scale, array or tensor) → features
    f32[B, T, num_bins] on ``device`` (default: the wave's).  Dither, when
    configured, draws from ``generator``; without one it is off."""
    wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
    B, N = wave.shape
    T = num_frames(cfg, N)
    if T <= 0:
        return torch.zeros((B, 0, cfg.num_bins), device=wave.device)
    idx = (torch.arange(T, device=wave.device)[:, None] * cfg.window_shift
           + torch.arange(cfg.window_size, device=wave.device)[None, :])
    # without snip_edges the last frames run past the wave: they repeat
    # its last sample, as the JAX version's clamped gather does
    frames = wave[:, idx.clamp(max=N - 1)]                   # [B,T,win]
    if cfg.dither > 0 and generator is not None:
        frames = frames + cfg.dither * torch.randn(
            frames.shape, generator=generator).to(wave.device)
    return fbank_frames(cfg, frames)


def frame_rows(cfg: FbankConfig, wave: np.ndarray) -> np.ndarray:
    """wave f32[B, N] → its frames f32[B, T, window_size] on the host,
    the samples ``compute_fbank`` gathers for them (past the wave's end,
    without snip_edges, its last sample)."""
    N = wave.shape[1]
    T = num_frames(cfg, N)
    if T <= 0:
        return np.zeros((wave.shape[0], 0, cfg.window_size), np.float32)
    idx = (np.arange(T)[:, None] * cfg.window_shift
           + np.arange(cfg.window_size)[None, :])
    return wave[:, np.minimum(idx, N - 1)]


def fbank_frames(cfg: FbankConfig, frames: torch.Tensor) -> torch.Tensor:
    """The fbank of each frame f32[..., window_size] → f32[..., num_bins]
    (remove-DC, pre-emphasis, window, rFFT, power, mel product, log): the
    per-frame arithmetic of ``compute_fbank``, each frame on its own."""
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0:
        first = frames[..., :1] * (1.0 - cfg.preemphasis)
        rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    frames = frames * torch.from_numpy(_window_fn(cfg)).to(frames.device)
    spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=-1)
    power = spec.real.square() + spec.imag.square()
    if not cfg.use_power:
        power = power.sqrt()
    mel = torch.matmul(power, torch.from_numpy(mel_banks(cfg)).to(
        frames.device).t())
    if cfg.use_log:
        mel = torch.log(mel.clamp(min=1.1921e-7))  # FLT_EPSILON floor
    return mel


class StreamingFbank:
    """Chunked waveform → features with sample carry across calls: the
    ``ExtractFeat`` / ``ExtractFeat_Last`` contract of the reference
    frontend (ref: src/nnet/FeatureExtractor.h:58-80) — chunk boundaries
    do not change the features."""

    def __init__(self, cfg: FbankConfig, batch: int = 1, device=None):
        self.cfg = cfg
        self.batch = batch
        self.device = device
        self.reset()

    def reset(self) -> None:
        """ref: FeatureExtractor::Reset — call per utterance."""
        self._carry = np.zeros((self.batch, 0), np.float32)

    def accept(self, wave: np.ndarray, end: bool = False) -> torch.Tensor:
        """wave f32[B, n] chunk; returns the newly ready frames [B, t, M]."""
        return compute_fbank(self.cfg, self.take(wave, end), self.device)

    def take(self, wave: np.ndarray, end: bool = False) -> np.ndarray:
        """Append the chunk wave f32[B, n] to the carry and return the
        samples whose frames are ready, f32[B, m] (``compute_fbank`` of
        them is what ``accept`` returns); the carry keeps the rest."""
        cfg = self.cfg
        wave = np.concatenate([self._carry, np.asarray(wave, np.float32)],
                              axis=1)
        if end:
            self._carry = np.zeros((self.batch, 0), np.float32)
            return wave
        T = num_frames(cfg, wave.shape[1])
        if T <= 0:
            self._carry = wave
            return wave[:, :0]
        usable = (T - 1) * cfg.window_shift + cfg.window_size
        self._carry = wave[:, T * cfg.window_shift:]
        return wave[:, :usable]


@dataclass
class CmvnConfig:
    """Live mean/variance normalization (ref: src/nnet/fbanks.cfg
    NORMVAR/NORMVARFLOOR/NORMVARFORGETTINGFACTOR)."""
    norm_mean: bool = flag(True, "Subtract running mean")
    norm_var: bool = flag(False, "Divide by running stddev")
    forgetting_factor: float = flag(0.992, "Exponential forgetting factor")
    var_floor: float = flag(1e-4, "Variance floor")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


def live_cmvn(cfg: CmvnConfig, feats: torch.Tensor, state=None):
    """Exponential-forgetting streaming CMVN: feats f32[B,T,D]; state =
    (mean [B,D], var [B,D]) or None to boot from the first frame.
    Returns (normalized, new_state)."""
    B, T, D = feats.shape
    if state is None:
        state = (feats[:, 0], torch.ones((B, D), device=feats.device))
    mean, var = state
    rho = cfg.forgetting_factor
    out = torch.empty_like(feats)
    for t in range(T):
        x = feats[:, t]
        mean = rho * mean + (1 - rho) * x
        var = rho * var + (1 - rho) * (x - mean).square()
        y = x
        if cfg.norm_mean:
            y = y - mean
        if cfg.norm_var:
            y = y / var.clamp(min=cfg.var_floor).sqrt()
        out[:, t] = y
    return out, (mean, var)


def utterance_cmvn(feats: torch.Tensor, norm_var: bool = False,
                   eps: float = 1e-4) -> torch.Tensor:
    """Whole-utterance CMVN (offline; Kaldi apply-cmvn equivalent)."""
    out = feats - feats.mean(dim=1, keepdim=True)
    if norm_var:
        out = out / out.square().mean(dim=1, keepdim=True).clamp(
            min=eps).sqrt()
    return out
