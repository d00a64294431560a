"""Composed streaming frontend: fbank (+ live CMVN) (+ deltas).

Port of ``asr_decoder_tpu/frontend/pipeline.py`` (ref: the ``DnnFeat`` /
``OnlineDeltaFeature`` stack, src/nnet/nnet-feature-api.h:10-185,
src/pitch/online-feature.h:30-50).  Stream-vs-offline equivalence holds
chunk by chunk: delta frames are emitted only once their right context
exists (repeat-padded at EOS).  The delta code is the JAX module's numpy,
repeated here because that module imports JAX.  Kaldi pitch
(``DnnPitchFeat``) is not ported yet (ROADMAP §1) and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.frontend.fbank import (FbankConfig, StreamingFbank,
                                                  live_cmvn)


@dataclass
class DeltaConfig:
    """ref: DeltaFeaturesOptions (src/pitch/online-feature.h:30-50)."""
    order: int = flag(2, "Delta order (0 = off, 2 = delta+accel)")
    window: int = flag(2, "Half-window per delta order")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def context(self) -> int:
        return self.order * self.window


def delta_coeffs(order: int, window: int) -> list[np.ndarray]:
    """Kaldi delta filter bank: coeffs[o] spans ±o·window."""
    coeffs = [np.array([1.0], np.float64)]
    norm = 1.0 / (2.0 * sum(i * i for i in range(1, window + 1)))
    for _ in range(order):
        prev = coeffs[-1]
        cur = np.zeros(len(prev) + 2 * window, np.float64)
        for j in range(-window, window + 1):
            cur[j + window:j + window + len(prev)] += j * norm * prev
        coeffs.append(cur)
    return coeffs


def compute_deltas(feats: np.ndarray, cfg: DeltaConfig) -> np.ndarray:
    """[..., T, D] → [..., T, D·(order+1)] with edge replication."""
    feats = np.asarray(feats, np.float32)
    if cfg.order == 0:
        return feats
    T = feats.shape[-2]
    C = cfg.context
    if T == 0:
        return feats.repeat(cfg.order + 1, axis=-1)
    idx = np.clip(np.arange(-C, T + C), 0, T - 1)
    padded = feats[..., idx, :]                      # [..., T+2C, D]
    outs = []
    for o, co in enumerate(delta_coeffs(cfg.order, cfg.window)):
        span = o * cfg.window
        acc = np.zeros_like(feats, np.float64)
        for k, c in enumerate(co):
            if c != 0.0:
                lo = C - span + k
                acc += c * padded[..., lo:lo + T, :]
        outs.append(acc.astype(np.float32))
    return np.concatenate(outs, axis=-1)


class StreamingDelta:
    """Streaming deltas: emits frame t once its right context (order·window
    frames) exists; EOS repeat-pads (ref OnlineDeltaFeature semantics)."""

    def __init__(self, cfg: DeltaConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self._buf: np.ndarray | None = None
        self._next = 0

    def accept(self, feats: np.ndarray, end: bool = False) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        if self._buf is None:
            self._buf = feats
        elif feats.shape[-2]:
            self._buf = np.concatenate([self._buf, feats], axis=-2)
        buf = self._buf
        stop = buf.shape[-2] if end else buf.shape[-2] - self.cfg.context
        if buf.shape[-2] == 0 or stop <= self._next:
            D = buf.shape[-1] * (self.cfg.order + 1)
            return np.zeros(buf.shape[:-2] + (0, D), np.float32)
        out = compute_deltas(buf, self.cfg)[..., self._next:stop, :]
        self._next = stop
        return out


class StreamingFrontend:
    """fbank (+ live CMVN) (+ deltas) with exactly-once frame emission.

    ``accept(pcm[B, n], end)`` → new frames np.float32[B, t, D]; the fbank
    and CMVN run on ``device``, deltas on the host."""

    def __init__(self, fbank_cfg: FbankConfig, batch: int = 1,
                 pitch_cfg=None, delta_cfg: DeltaConfig | None = None,
                 cmvn_cfg=None, device=None):
        if pitch_cfg is not None:
            raise NotImplementedError(
                "pitch features are not ported to asr_decoder_tpu_torch yet "
                "(ROADMAP §1: pitch, VAD and wakeup)")
        self._fbank = StreamingFbank(fbank_cfg, batch=batch, device=device)
        self._cmvn_cfg = cmvn_cfg
        self._delta = (StreamingDelta(delta_cfg)
                       if delta_cfg is not None and delta_cfg.order
                       else None)
        self.dim = fbank_cfg.num_bins * ((delta_cfg.order + 1)
                                         if self._delta is not None else 1)
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self._fbank.reset()
        if self._delta is not None:
            self._delta.reset()
        self._cmvn_state = None

    @torch.inference_mode()
    def accept(self, pcm: np.ndarray, end: bool = False) -> np.ndarray:
        feats = self._fbank.accept(np.asarray(pcm, np.float32), end=end)
        if self._cmvn_cfg is not None and feats.shape[1]:
            feats, self._cmvn_state = live_cmvn(self._cmvn_cfg, feats,
                                                self._cmvn_state)
        feats = feats.cpu().numpy()
        if self._delta is not None:
            feats = self._delta.accept(feats, end=end)
        return feats
