"""The loop both offline kinds share: a pool of batches made in set-up,
one batch warmed outside the window, then batches back to back from the
pool's start until the first batch that ends at or after ``seconds``;
``offline_audio_s_per_s`` is the audio of every batch whose words came
back, over that whole time.  In a traced run each stage is a span and
the device trace covers a few batches in the middle."""

from __future__ import annotations

import time

from benchmark import harness


def loop(ctx, pool_size: int, one_batch, audio_s: float) -> dict:
    """``one_batch(i, first_pass) -> None`` runs batch ``i`` of the pool
    to its words (``first_pass``: it is the window's first run of batch
    i, whose outputs are kept for the judge).  Returns the window and the
    batch count, and the device trace in a traced run."""
    p = ctx.params
    one_batch(0, False)                              # warm, outside
    out = {}
    t0 = time.perf_counter()
    out["t0_monotonic"] = time.monotonic()
    n = 0
    prof, prof_at = None, None
    if ctx.trace:
        prof_at = t0 + max(0.0, (ctx.seconds - p["profile_s"]) / 2)
    while True:
        if prof_at is not None and prof is None and \
                time.perf_counter() >= prof_at:
            prof = harness.Profiler()
            prof.start()
        one_batch(n % pool_size, n < pool_size)
        n += 1
        now = time.perf_counter()
        if prof is not None and "trace" not in out and \
                now >= prof_at + p["profile_s"]:
            out["trace"] = prof.stop()
        if now - t0 >= ctx.seconds:
            break
    if prof is not None and "trace" not in out:
        out["trace"] = prof.stop()
    out.update(window=(t0, now), batches=n, audio_s=n * audio_s)
    return out
