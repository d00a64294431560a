"""Profiler integration: ``torch.profiler`` traces and named ranges.

Port of ``asr_decoder_tpu/utils/profiling.py``.  ``scope(name)`` marks a
range of the search (``search/emit``, ``search/eps``, ``search/emit3``,
``search/eps3``) that shows in a trace and in ``key_averages()`` by name
where the search runs eagerly (on the CPU; on the card a captured frame
graph's replays carry no ranges, so per-stage device time there is read
from the kernels' names);
``trace(dir)`` records a block with ``torch.profiler`` (host, and the card
where there is one) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_RANGE = nullcontext()


def scope(name: str):
    """Named range for device code: the ops launched inside it are grouped
    under ``name`` in a trace (``with scope("search/emit"): ...``).  With no
    profiler recording it is a no-op, so the search's hot path pays no
    dispatcher call for it, as JAX's ``named_scope`` costs nothing at run
    time."""
    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return record_function(name)


# torch.profiler has one kind of range for host and device spans
annotate = scope


@contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (Chrome trace format); yields the profiler, so
    the caller can read ``key_averages()`` after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
