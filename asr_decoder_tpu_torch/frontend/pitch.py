"""Pitch frontend in PyTorch: NCCF + Viterbi pitch tracking + POV
post-processing.

Port of ``asr_decoder_tpu/frontend/pitch.py`` (ref: the Kaldi-pitch port —
NCCF extraction and online Viterbi pitch tracking,
src/pitch/pitch-functions.cc:1229-1272 ``OnlinePitchFeature``; POV,
normalization and delta post-processing, ``OnlineProcessPitch``
pitch-functions.h:314, conf src/nnet/online_pitch.conf; the streaming
wrapper ``StreamPitch`` pitch-functions.h:432-520; the resampler
``LinearResample`` src/pitch/resample.h:124).

Every product in this module is an elementwise multiply and a sum — the
resampler's strided convolution over gathered windows, the NCCF
contraction ``btw,btlw->btl`` over the gathered ``[B, T, L, W]`` lag
windows, the arbitrary resampler's ``[P, N]`` weights — so it runs in full
f32 on the card whatever a caller sets: a cuDNN convolution would take
TF32 by default (``torch.backends.cudnn.allow_tf32``), and TF32 rounding
moves the NCCF enough to flip the Viterbi lag path.

The Viterbi forward pass runs on the device, a min-plus step of three
kernels per frame over the ``[B, L, L]`` lag transitions (``torch.min``
keeps ``argmin``'s first-index tie rule); the backtrack walks the copied
backpointers on the host, where a dependent lookup per frame costs no
launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag


@dataclass
class PitchConfig:
    """ref: PitchExtractionOptions (pitch-functions.h:23-100)."""
    sample_rate: int = flag(16000, "Input waveform sample rate")
    frame_shift_ms: float = flag(10.0, "Frame shift (ms)")
    frame_length_ms: float = flag(25.0, "NCCF window length (ms)")
    min_f0: float = flag(50.0, "Minimum F0 to search (Hz)")
    max_f0: float = flag(400.0, "Maximum F0 to search (Hz)")
    resample_freq: float = flag(4000.0, "Internal analysis sample rate")
    lowpass_cutoff: float = flag(1000.0, "Anti-alias lowpass cutoff (Hz)")
    lowpass_filter_width: int = flag(1, "Lowpass sinc half-width (periods)")
    soft_min_f0: float = flag(10.0, "Soft minimum F0 for ballast")
    penalty_factor: float = flag(0.1, "Transition cost on log-lag change")
    nccf_ballast: float = flag(7000.0, "NCCF ballast term")
    lag_bias: float = flag(
        0.01, "Short-lag preference per log-lag unit in the Viterbi local "
              "cost — octave-error guard (periodic signals tie NCCF at lag "
              "multiples; the reference resolves this via its ballast/lag "
              "selection, pitch-functions.cc SelectLags)")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def frames_shift(self) -> int:
        return int(self.resample_freq * self.frame_shift_ms / 1000)

    @property
    def window_size(self) -> int:
        return int(self.resample_freq * self.frame_length_ms / 1000)

    def lags(self) -> np.ndarray:
        lo = int(np.floor(self.resample_freq / self.max_f0))
        hi = int(np.ceil(self.resample_freq / self.min_f0))
        return np.arange(lo, hi + 1, dtype=np.int32)


@dataclass
class ProcessPitchConfig:
    """ref: ProcessPitchOptions (pitch-functions.h:193-260)."""
    pitch_scale: float = flag(2.0, "Scale on normalized log pitch")
    pov_scale: float = flag(2.0, "Scale on the POV feature")
    delta_pitch_scale: float = flag(10.0, "Scale on delta log pitch")
    normalization_left_context: int = flag(75, "CMN window left (frames)")
    normalization_right_context: int = flag(75, "CMN window right (frames)")
    delta_window: int = flag(2, "Delta regression half-window")
    add_pov_feature: bool = flag(True, "Emit the POV feature")
    add_normalized_log_pitch: bool = flag(True, "Emit normalized log pitch")
    add_delta_pitch: bool = flag(True, "Emit delta log pitch")
    add_raw_log_pitch: bool = flag(False, "Emit raw log pitch")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def dim(self) -> int:
        return (int(self.add_pov_feature)
                + int(self.add_normalized_log_pitch)
                + int(self.add_delta_pitch) + int(self.add_raw_log_pitch))


def resample_kernel(cfg: PitchConfig) -> tuple[np.ndarray, int]:
    """Windowed-sinc decimation kernel (ref: LinearResample's lowpass
    filter, resample.cc); returns (kernel f32[W], stride)."""
    stride = int(round(cfg.sample_rate / cfg.resample_freq))
    cutoff = cfg.lowpass_cutoff / cfg.sample_rate  # normalized
    half = int(np.ceil(cfg.lowpass_filter_width * cfg.sample_rate
                       / (2 * cfg.lowpass_cutoff)))
    n = np.arange(-half, half + 1)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * n)
    win = np.hanning(len(n) + 2)[1:-1]
    k = (sinc * win).astype(np.float32)
    return k / k.sum(), stride


def _windows(x: torch.Tensor, count: int, step: int, width: int
             ) -> torch.Tensor:
    """[B, N] → the ``count`` windows [B, count, width] starting every
    ``step`` samples (a gather)."""
    idx = (torch.arange(count, device=x.device)[:, None] * step
           + torch.arange(width, device=x.device)[None, :])
    return x[:, idx]


def linear_resample(cfg: PitchConfig, wave: torch.Tensor) -> torch.Tensor:
    """wave f32[B, N] at sample_rate → f32[B, N'] at resample_freq: the
    JAX module's strided convolution (zero padding W//2 a side), as a
    gather of windows and a multiply-sum (ref: LinearResample::Resample,
    resample.h:124)."""
    k, stride = resample_kernel(cfg)
    W = len(k)
    x = torch.nn.functional.pad(wave, (W // 2, W // 2))
    T = max(0, (x.shape[1] - W) // stride + 1)
    kern = torch.from_numpy(k).to(wave.device)
    return (_windows(x, T, stride, W) * kern).sum(dim=-1)


def compute_nccf(cfg: PitchConfig, resampled: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """NCCF for every (frame, lag): f32[B, T, L] twice — with the ballast
    (pitch-search variant) and without (POV variant)
    (ref: ComputeNccf / ballast handling, pitch-functions.cc)."""
    lags = cfg.lags()
    W, shift = cfg.window_size, cfg.frames_shift
    maxlag = int(lags[-1])
    B, N = resampled.shape
    dev = resampled.device
    T = max(0, (N - (W + maxlag)) // shift + 1)
    if T == 0:
        Z = torch.zeros((B, 0, len(lags)), device=dev)
        return Z, Z
    idx0 = (torch.arange(T, device=dev)[:, None] * shift
            + torch.arange(W, device=dev)[None, :])
    x0 = resampled[:, idx0]                               # [B,T,W]
    x0 = x0 - x0.mean(dim=-1, keepdim=True)
    # shifted windows for every lag: gather [B,T,L,W]
    idx1 = idx0[:, None, :] + torch.from_numpy(lags).to(dev)[None, :, None]
    x1 = resampled[:, idx1]                               # [B,T,L,W]
    x1 = x1 - x1.mean(dim=-1, keepdim=True)
    cross = (x0[:, :, None, :] * x1).sum(dim=-1)          # btw,btlw->btl
    e0 = (x0 * x0).sum(dim=-1)[..., None]                 # [B,T,1]
    e1 = (x1 * x1).sum(dim=-1)                            # [B,T,L]
    # ballast ~ (soft-min-f0 window energy)^2 guard (ref ballast term)
    mean_sq = e0[..., 0] / W
    ballast = cfg.nccf_ballast * mean_sq.clamp(min=1e-10)[..., None]
    denom_pitch = torch.sqrt(e0 * e1 + ballast) + 1e-10
    denom_pov = torch.sqrt(e0 * e1) + 1e-10
    return cross / denom_pitch, (cross / denom_pov).clamp(-1.0, 1.0)


def _viterbi_track(local_cost: torch.Tensor, trans: torch.Tensor
                   ) -> torch.Tensor:
    """Min-plus Viterbi over lag candidates: local_cost f32[B,T,L],
    trans f32[L,L]; returns the best lag index per frame i64[B,T] on
    local_cost's device (ref: the online Viterbi in
    pitch-functions.cc:1229-1272)."""
    B, T, _ = local_cost.shape
    carry = local_cost[:, 0]
    backptrs = []
    for t in range(1, T):
        best, best_prev = (carry[:, :, None] + trans[None]).min(dim=1)
        backptrs.append(best_prev)
        carry = best + local_cost[:, t]
    idx = carry.argmin(dim=1).cpu().numpy()
    path = np.empty((B, T), np.int64)
    path[:, T - 1] = idx
    if T > 1:
        bp = torch.stack(backptrs).cpu().numpy()           # [T-1, B, L]
        rows = np.arange(B)
        for t in range(T - 2, -1, -1):
            idx = bp[t, rows, idx]
            path[:, t] = idx
    return torch.from_numpy(path).to(local_cost.device)


def compute_pitch(cfg: PitchConfig, wave, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """wave f32[B, N] (array or tensor) → (pitch_hz f32[B,T], nccf_pov
    f32[B,T]) on ``device`` (default: the wave's)
    (ref: ComputeKaldiPitch, pitch-functions.cc)."""
    wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
    dev = wave.device
    nccf_pitch, nccf_pov = compute_nccf(cfg, linear_resample(cfg, wave))
    lags = cfg.lags().astype(np.float32)
    if nccf_pitch.shape[1] == 0:
        z = torch.zeros(nccf_pitch.shape[:2], device=dev)
        return z, z
    loglag = np.log(lags)
    trans = (cfg.penalty_factor
             * (loglag[:, None] - loglag[None, :]) ** 2).astype(np.float32)
    local = (1.0 - nccf_pitch
             + cfg.lag_bias * torch.from_numpy(loglag - loglag[0]).to(dev))
    path = _viterbi_track(local, torch.from_numpy(trans).to(dev))
    pitch = cfg.resample_freq / torch.from_numpy(lags).to(dev)[path]
    pov_nccf = nccf_pov.gather(2, path[..., None])[..., 0]
    return pitch, pov_nccf


def nccf_to_pov_feature(c: torch.Tensor) -> torch.Tensor:
    """ref: NccfToPovFeature (pitch-functions.cc): 2((1.0001−c)^0.15 − 1)."""
    return 2.0 * (torch.pow(1.0001 - c, 0.15) - 1.0)


def _sliding_mean(x: torch.Tensor, w: torch.Tensor, left: int, right: int
                  ) -> torch.Tensor:
    """Weighted sliding mean of x (weights w) with edge-clamped windows."""
    T = x.shape[1]
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(-left, right + 1, device=x.device)[None, :]
           ).clamp(0, max(T - 1, 0))
    xs, ws = x[:, idx], w[:, idx]
    return (xs * ws).sum(dim=-1) / ws.sum(dim=-1).clamp(min=1e-10)


def process_pitch(pcfg: ProcessPitchConfig, pitch_hz: torch.Tensor,
                  nccf_pov: torch.Tensor) -> torch.Tensor:
    """(pitch, pov-NCCF) → feature rows f32[B, T, dim]
    (ref: OnlineProcessPitch, pitch-functions.h:314: POV feature,
    POV-weighted mean-normalized log pitch, delta log pitch)."""
    log_pitch = torch.log(pitch_hz.clamp(min=1e-10))
    # POV weight p(voiced) from NCCF (ref NccfToPov polynomial, approx.)
    c = nccf_pov.clamp(-1.0, 1.0)
    pov_weight = (1.001 - 1.0 / (1.0 + torch.exp(10.0 * c - 2.0))
                  ).clamp(0.0, 1.0)
    cols = []
    if pcfg.add_pov_feature:
        cols.append(pcfg.pov_scale * nccf_to_pov_feature(c))
    if pcfg.add_normalized_log_pitch:
        mean = _sliding_mean(log_pitch, pov_weight,
                             pcfg.normalization_left_context,
                             pcfg.normalization_right_context)
        cols.append(pcfg.pitch_scale * (log_pitch - mean))
    if pcfg.add_delta_pitch:
        # regression delta over ±delta_window (Kaldi delta formula)
        D = pcfg.delta_window
        T = log_pitch.shape[1]
        t = torch.arange(T, device=log_pitch.device)
        num = torch.zeros_like(log_pitch)
        den = 0.0
        for d in range(1, D + 1):
            plus = log_pitch[:, (t + d).clamp(0, max(T - 1, 0))]
            minus = log_pitch[:, (t - d).clamp(0, max(T - 1, 0))]
            num = num + d * (plus - minus)
            den += 2 * d * d
        cols.append(pcfg.delta_pitch_scale * num / den)
    if pcfg.add_raw_log_pitch:
        cols.append(log_pitch)
    return torch.stack(cols, dim=-1)


def compute_and_process_pitch(cfg: PitchConfig, pcfg: ProcessPitchConfig,
                              wave, device=None) -> torch.Tensor:
    """Offline one-call pipeline (ref: compute-and-process-kaldi-pitch-feats
    tool, src/pitch/compute-and-process-kaldi-pitch-feats.cc)."""
    pitch, pov = compute_pitch(cfg, wave, device)
    return process_pitch(pcfg, pitch, pov)


class StreamPitch:
    """Chunked streaming wrapper (ref: StreamPitch::ProcessWave,
    pitch-functions.h:432-520).  Keeps the whole wave so far on ``device``
    and re-runs the tracking over it at every push (the JAX design: the
    work per push grows with the stream), re-emitting only newly stable
    frames; at EOS the stream equals the offline features."""

    def __init__(self, cfg: PitchConfig, pcfg: ProcessPitchConfig,
                 batch: int = 1, device="cuda"):
        self.cfg, self.pcfg = cfg, pcfg
        self.batch = batch
        self.device = device
        self.reset()

    def reset(self) -> None:
        self._wave = torch.zeros((self.batch, 0), device=self.device)
        self._emitted = 0

    @torch.inference_mode()
    def process_wave(self, chunk: np.ndarray, end: bool = False
                     ) -> np.ndarray:
        chunk = torch.from_numpy(np.asarray(chunk, np.float32))
        self._wave = torch.cat([self._wave, chunk.to(self._wave.device)],
                               dim=1)
        feats = compute_and_process_pitch(self.cfg, self.pcfg,
                                          self._wave).cpu().numpy()
        T = feats.shape[1]
        ready = T if end else self._emitted  # hold frames until EOS refines
        if not end:
            # frames older than the normalization right context are stable
            ready = max(self._emitted,
                        T - self.pcfg.normalization_right_context - 1)
        out = feats[:, self._emitted:ready]
        self._emitted = ready
        return out


def merge_features(fbank: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """Per-frame (fbank ‖ pitch) merge, truncating to the shorter stream
    (ref: DnnPitchFeat::MergeFeat, src/nnet/nnet-feature-pitch-api.cc)."""
    T = min(fbank.shape[-2], pitch.shape[-2])
    return np.concatenate([np.asarray(fbank)[..., :T, :],
                           np.asarray(pitch)[..., :T, :]], axis=-1)


class ArbitraryResample:
    """Resample a signal at arbitrary (possibly non-uniform) time points
    (ref: ArbitraryResample, src/pitch/resample.h:72-120 — used by the
    Kaldi pitch extractor to evaluate NCCF lags off the sample grid).

    ``sample_points``: output times in seconds.  Each output is a
    windowed-sinc (Hanning-windowed, ``num_zeros`` half-lobes) interpolation
    of the input at that time, weighted by a dense [P, N] matrix on
    ``device``.
    """

    def __init__(self, num_samples_in: int, samp_rate_in: float,
                 filter_cutoff: float, sample_points, num_zeros: int = 4,
                 device="cuda"):
        if not 0 < filter_cutoff < samp_rate_in / 2:
            raise ValueError(f"filter_cutoff {filter_cutoff} outside "
                             f"(0, {samp_rate_in / 2})")
        self.num_samples_in = int(num_samples_in)
        pts = np.asarray(sample_points, np.float64)
        half_width = num_zeros / (2.0 * filter_cutoff)
        t_in = np.arange(num_samples_in) / samp_rate_in        # [N]
        delta = t_in[None, :] - pts[:, None]                   # [P, N]
        inside = np.abs(delta) < half_width
        x = np.where(inside, delta, 0.0)
        window = 0.5 * (1.0 + np.cos(np.pi * filter_cutoff / num_zeros
                                     * 2.0 * x))
        sinc = 2 * filter_cutoff * np.sinc(2 * filter_cutoff * x)
        self.weights = torch.from_numpy(np.where(
            inside, window * sinc / samp_rate_in, 0.0).astype(np.float32)
        ).to(device)

    @torch.inference_mode()
    def resample(self, wave) -> torch.Tensor:
        """f32[..., N] → f32[..., P] values at the sample points
        (``...n,pn->...p``)."""
        wave = torch.as_tensor(wave, dtype=torch.float32,
                               device=self.weights.device)
        return (wave[..., None, :] * self.weights).sum(dim=-1)
