"""Composed streaming frontend: fbank (+ live CMVN) (‖ pitch) (+ deltas).

Port of ``asr_decoder_tpu/frontend/pipeline.py`` (ref: the ``DnnFeat`` /
``DnnPitchFeat`` / ``OnlineDeltaFeature`` stack, src/nnet/nnet-feature-
api.h:10-185 — DnnPitchFeat runs fbank and Kaldi-pitch in parallel and
merges per frame; src/pitch/online-feature.h:30-50).  Stream-vs-offline
equivalence holds chunk by chunk: merged frames are emitted only once both
streams have produced them, delta frames only once their right context
exists (repeat-padded at EOS).  The delta and merge code is the JAX
module's numpy, repeated here because that module imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag
from asr_decoder_tpu_torch.frontend.fbank import (FbankConfig, StreamingFbank,
                                                  live_cmvn)
from asr_decoder_tpu_torch.frontend.pitch import (PitchConfig,
                                                  ProcessPitchConfig,
                                                  StreamPitch)


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

    def __init__(self, cfg: DeltaConfig, batch: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self._buf: np.ndarray | None = None
        self._next = 0

    def accept(self, feats: np.ndarray, end: bool = False) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        if self.cfg.order == 0:
            return feats
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


@dataclass
class FrontendConfig:
    """Frontend composition switches (the DnnFeat vs DnnPitchFeat choice,
    ref nnet-feature-api.h:10,86)."""
    use_pitch: bool = flag(False, "Append Kaldi-pitch features (3-dim)")
    use_delta: bool = flag(False, "Append delta features")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class StreamingFrontend:
    """fbank (+ live CMVN) (‖ pitch) (+ deltas) with exactly-once frame
    emission.

    ``accept(pcm[B, n], end)`` → new frames np.float32[B, t, D]; the fbank,
    CMVN and pitch run on ``device``, the merge and deltas on the host.
    CMVN applies to the fbank block only (the reference's live-CMN lives
    inside the fbank frontend, nnet/fbanks.cfg)."""

    def __init__(self, fbank_cfg: FbankConfig, batch: int = 1,
                 pitch_cfg: PitchConfig | None = None,
                 ppitch_cfg: ProcessPitchConfig | None = None,
                 delta_cfg: DeltaConfig | None = None,
                 cmvn_cfg=None, device=None):
        self._fbank = StreamingFbank(fbank_cfg, batch=batch, device=device)
        self._cmvn_cfg = cmvn_cfg
        self._pitch = (StreamPitch(pitch_cfg, ppitch_cfg, batch=batch,
                                   device=device)
                       if pitch_cfg is not None else None)
        self._delta = (StreamingDelta(delta_cfg, batch=batch)
                       if delta_cfg is not None and delta_cfg.order
                       else None)
        base = fbank_cfg.num_bins + (ppitch_cfg.dim if ppitch_cfg is not None
                                     else 0)
        self.dim = base * ((delta_cfg.order + 1)
                           if self._delta is not None else 1)
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self._fbank.reset()
        if self._pitch is not None:
            self._pitch.reset()
        if self._delta is not None:
            self._delta.reset()
        self._fpend: np.ndarray | None = None
        self._ppend: np.ndarray | None = None
        self._flast: np.ndarray | None = None   # last seen frame per stream
        self._plast: np.ndarray | None = None
        self._cmvn_state = None

    def _merge(self, end: bool) -> np.ndarray:
        """Emit min(len(fbank), len(pitch)) buffered frames, keep the rest;
        at EOS the shorter stream is repeat-padded with its last frame
        (fbank/pitch counts differ by ≤2 there)
        (ref DnnPitchFeat::MergeFeat, nnet-feature-pitch-api.cc)."""
        f, p = self._fpend, self._ppend
        if f.shape[1]:
            self._flast = f[:, -1:]
        if p.shape[1]:
            self._plast = p[:, -1:]
        if end:
            m = max(f.shape[1], p.shape[1])

            def pad(x, last):
                k = m - x.shape[1]
                if k == 0:
                    return x
                if last is None:
                    raise ValueError("a frontend stream produced no frames "
                                     "at all")
                return np.concatenate(
                    [x, np.repeat(last, k, axis=1)], axis=1)
            f = pad(f, self._flast)
            p = pad(p, self._plast)
        n = min(f.shape[1], p.shape[1])
        out = np.concatenate([f[:, :n], p[:, :n]], axis=-1)
        self._fpend, self._ppend = f[:, n:], p[:, n:]
        return out

    @torch.inference_mode()
    def accept(self, pcm: np.ndarray, end: bool = False) -> np.ndarray:
        pcm = np.asarray(pcm, np.float32)
        feats = self._fbank.accept(pcm, end=end)
        if self._cmvn_cfg is not None and feats.shape[1]:
            feats, self._cmvn_state = live_cmvn(self._cmvn_cfg, feats,
                                                self._cmvn_state)
        feats = feats.cpu().numpy()
        if self._pitch is not None:
            pf = self._pitch.process_wave(pcm, end=end)
            self._fpend = feats if self._fpend is None else \
                np.concatenate([self._fpend, feats], axis=1)
            self._ppend = pf if self._ppend is None else \
                np.concatenate([self._ppend, pf], axis=1)
            feats = self._merge(end)
        if self._delta is not None:
            feats = self._delta.accept(feats, end=end)
        return feats
