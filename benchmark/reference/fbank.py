"""Kaldi log-mel filterbank over whole waves (snip_edges, povey window,
pre-emphasis, DC removal, power spectrum, log floored at FLT_EPSILON):
a plain copy of the port's ``frontend/fbank.py:compute_fbank`` arithmetic
without dither."""

from __future__ import annotations

import numpy as np
import torch


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def fbank(wave: torch.Tensor, num_bins: int, sample_rate: int = 16000,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
          low_freq: float = 20.0, preemphasis: float = 0.97) -> torch.Tensor:
    """wave f32[B, N] at 16-bit scale -> f32[B, T, num_bins]."""
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    nfft = 1 << (win - 1).bit_length()
    B, N = wave.shape
    T = 0 if N < win else 1 + (N - win) // shift
    dev = wave.device
    idx = (torch.arange(T, device=dev)[:, None] * shift
           + torch.arange(win, device=dev)[None, :])
    x = wave[:, idx]
    x = x - x.mean(dim=-1, keepdim=True)
    x = torch.cat([x[..., :1] * (1.0 - preemphasis),
                   x[..., 1:] - preemphasis * x[..., :-1]], dim=-1)
    i = np.arange(win)
    window = ((0.5 - 0.5 * np.cos(2 * np.pi / (win - 1) * i)) ** 0.85)
    x = x * torch.from_numpy(window.astype(np.float32)).to(dev)
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    lo, hi = _mel(low_freq), _mel(sample_rate / 2)
    delta = (hi - lo) / (num_bins + 1)
    mf = _mel(np.arange(nfft // 2 + 1) * (sample_rate / nfft))
    banks = np.zeros((num_bins, nfft // 2 + 1), np.float32)
    for b in range(num_bins):
        left, center, right = lo + b * delta, lo + (b + 1) * delta, \
            lo + (b + 2) * delta
        banks[b] = np.maximum(0.0, np.minimum((mf - left) / (center - left),
                                              (right - mf) / (right - center)))
    mel = power @ torch.from_numpy(banks).to(dev).t()
    return torch.log(mel.clamp(min=1.1921e-7))
