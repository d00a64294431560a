"""Keyword wakeup by posterior-sequence DTW, in PyTorch.

Port of ``asr_decoder_tpu/wakeup/dtw.py`` (ref: DTW alignment of the AM's
per-frame keyword-state posteriors against a keyword state template,
src/wakeup/dtw.h:30 ``DtwAlign``, and the streaming search wrapper with
per-window wake judgement, src/wakeup/wakeup-search.h:23
``WakeupSearch::{InputDataOneFrame,ProcessData,JudgeWakeup}``).

The DTW recurrence is a loop over frames whose carry is the whole DP
column: each step is a vectorized 3-way min over template states (and over
a batch of keywords or candidate starts), the within-frame step a prefix
min (``torch.cummin`` in place of ``lax.cummin``) — a few kernels a frame
on the device instead of the reference's scalar cell loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asr_decoder_tpu_torch.utils.config import ConfigOptions, flag


@dataclass
class WakeupConfig:
    """ref: wakeup-search.h options."""
    window_frames: int = flag(100, "Sliding window length (frames)")
    window_shift: int = flag(20, "Wake re-judgement interval (frames)")
    wake_threshold: float = flag(
        0.55, "Mean per-frame template posterior to wake")
    min_frames: int = flag(30, "Shortest window worth judging")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


@torch.inference_mode()
def dtw_align(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched DTW over cost f32[B, T, S] (frame t vs template state s).

    Standard symmetric DTW with steps (t-1,s), (t-1,s-1), (t,s-1) as a loop
    over frames; the (t,s-1) within-frame step is a monotonic prefix-min
    instead of a sequential state loop.  Returns (total f32[B] =
    D[T-1,S-1], dp f32[B,T,S]) on cost's device.
    """
    B, T, S = cost.shape
    # frame 0: D[0,s] = cumsum of costs along the template (only (t,s-1))
    cur = torch.cumsum(cost[:, 0], dim=1)
    rows = [cur]
    inf = torch.full((B, 1), float("inf"), device=cost.device)
    for t in range(1, T):
        c = cost[:, t]
        diag = torch.cat([inf, cur[:, :-1]], dim=1)
        base = torch.minimum(cur, diag) + c
        # within-frame advance: d[s] = min(base[s], d[s-1] + c[s]) — a
        # prefix-min over base[k] + suffix-sums of c
        csum = torch.cumsum(c, dim=1)
        cur = torch.cummin(base - csum, dim=1).values + csum
        rows.append(cur)
    dp = torch.stack(rows, dim=1)
    return dp[:, -1, -1], dp


def keyword_cost(posteriors: torch.Tensor, template: np.ndarray
                 ) -> torch.Tensor:
    """cost[t, s] = −log p(state_s | frame_t) for a keyword's pdf-id
    template (ref: the wakeup template is a keyword state sequence), on
    the posteriors' device."""
    tpl = torch.as_tensor(np.asarray(template, np.int64),
                          device=posteriors.device)
    return -torch.log(posteriors[..., tpl].clamp(min=1e-10))


class WakeupSearch:
    """Streaming keyword spotting (ref: wakeup-search.h:23).

    Feed per-frame AM posteriors; every ``window_shift`` frames the last
    ``window_frames`` are DTW-aligned on ``device`` against the keyword
    template and the confidence (mean matched posterior) is compared to the
    threshold.
    """

    def __init__(self, config: WakeupConfig, template: np.ndarray,
                 device="cuda"):
        self.config = config
        self.template = np.asarray(template, np.int32)
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self._frames: list[np.ndarray] = []
        self._since_judge = 0
        self.woken = False
        self.confidence = 0.0
        self.wake_range: tuple[int, int] | None = None

    def input_frame(self, posterior: np.ndarray) -> bool:
        """One posterior row f32[V] (ref: InputDataOneFrame)."""
        self._frames.append(np.asarray(posterior, np.float32))
        self._since_judge += 1
        if (self._since_judge >= self.config.window_shift
                and len(self._frames) >= self.config.min_frames):
            self._since_judge = 0
            self._judge()
        return self.woken

    def process_data(self, posteriors: np.ndarray, end: bool = False) -> bool:
        """A chunk of posterior rows f32[T, V] (ref: ProcessData)."""
        for row in np.asarray(posteriors, np.float32):
            if self.input_frame(row):
                return True
        if end and self._frames and not self.woken:
            self._since_judge = 0
            self._judge()
        return self.woken

    @torch.inference_mode()
    def _judge(self) -> None:
        """ref: JudgeWakeup(start, end) — the keyword may begin anywhere in
        the window, so a batch of candidate start offsets is judged in ONE
        batched dtw_align call: for candidate start k, frames before k are
        masked to free-stay in template state 0 (cost 0) and BIG elsewhere,
        which reduces the DTW to the [k:] suffix; each total is normalized
        by its own worst-case path length."""
        BIG = 1e9
        W = self.config.window_frames
        window = np.stack(self._frames[-W:])
        base = len(self._frames) - len(window)
        T, S = len(window), len(self.template)
        starts = list(range(0, T - S + 1, max(1, self.config.window_shift)))
        if not starts:
            return
        dev = self.device
        cost = keyword_cost(torch.from_numpy(window).to(dev), self.template)
        before = (torch.arange(T, device=dev)[None, :, None]
                  < torch.tensor(starts, device=dev)[:, None, None])
        masked = torch.where(torch.arange(S, device=dev) == 0, 0.0, BIG)
        cands = torch.where(before, masked, cost)       # [len(starts),T,S]
        totals, _ = dtw_align(cands)
        lens = np.array([T - k + S - 1 for k in starts], np.float32)
        confs = np.exp(-totals.cpu().numpy() / lens)
        best = int(np.argmax(confs))
        conf = float(confs[best])
        if conf > self.confidence:
            self.confidence = conf
            self.wake_range = (base + starts[best], len(self._frames))
        if conf >= self.config.wake_threshold:
            self.woken = True
