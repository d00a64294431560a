"""Wall-clock stopwatch + RTF accounting.

Capability parity with the reference ``Time`` (ref: src/util/util-time.h:8-23,
method `Esapsed` [sic]) and the per-utterance RTF bookkeeping the services log
(ref: src/v1-asr/v1-asr-task.h:238-251, src/service2/thread-info.h:10-23).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


@dataclass
class RtfStats:
    """Aggregated real-time-factor accounting with the reference's semantics:
    wav-time (audio seconds), nosil-time (speech-only seconds after VAD) and
    run-time (wall seconds spent decoding)."""

    wav_time: float = 0.0
    nosil_time: float = 0.0
    run_time: float = 0.0
    utts: int = 0

    def add(self, wav_time: float, run_time: float,
            nosil_time: float | None = None) -> None:
        self.wav_time += wav_time
        self.run_time += run_time
        self.nosil_time += nosil_time if nosil_time is not None else wav_time
        self.utts += 1

    @property
    def rtf(self) -> float:
        """run_time / wav_time — the reference's `decoder rt` metric."""
        return self.run_time / self.wav_time if self.wav_time else 0.0

    @property
    def nosil_rtf(self) -> float:
        return self.run_time / self.nosil_time if self.nosil_time else 0.0

    @property
    def speedup(self) -> float:
        """Audio-seconds decoded per wall-second (1/RTF)."""
        return self.wav_time / self.run_time if self.run_time else 0.0
