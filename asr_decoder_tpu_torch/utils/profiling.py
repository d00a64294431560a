"""Profiler integration: named ranges, program spans and ``torch.profiler``
traces.

Port of ``asr_decoder_tpu/utils/profiling.py``.  ``scope(name)`` marks a
range of the search (``search/emit``, ``search/eps``, ``search/emit3``,
``search/eps3``) that shows in a trace and in ``key_averages()`` by name
where the search runs eagerly (on the CPU; on the card a captured frame
graph's replays carry no ranges, so per-stage device time there is read
from the kernels' names);
``trace(dir)`` records a block with ``torch.profiler`` (host, and the card
where there is one) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``.

Spans.  ``span(name, req)`` times a block of the program on the host's
``time.perf_counter`` clock, always, into one process-wide ring
(``RING``, ``SPAN_CAPACITY`` spans; the oldest are overwritten and counted
once it is full).  A span is ``(name, thread, start, end, req, parent)``:
``req`` names the request it served (inherited from the enclosing span
when not given), ``parent`` is the enclosing span's name in the same
thread or asyncio task.  ``spans(t0, t1)`` returns those that lie inside an
interval, ``lost(t0)`` says whether the ring overwrote any that ended at or
after ``t0``.  Under a recording ``torch.profiler`` (on that thread) a span
also opens a ``record_function`` range, so ``trace(dir)`` shows the spans
beside the kernels they launched.  A span costs a microsecond or two of
host time and does nothing on the device.

The names, each written at its call site:

* ``serving/server.py``: ``request`` (a packet's handling, from its read to
  its reply's write and, after a final, its channel's release; ``req`` =
  (connection serial, packet ``n``)), and inside it ``admission`` (the wait
  for a free channel), ``pump`` (until the arena has consumed the push) and
  ``write``; on the device thread ``device/queue`` (submit to start) before
  each ``device/<call>`` (``push``, ``ready``, ``endpoint_detected``,
  ``snapshot``, ``step``, ``acquire``, ``release``, ``init_decoding``); on
  a result thread ``results/queue`` and ``results/build``, inside it
  ``result/traceback`` and ``result/align``.
* ``serving/batcher.py`` ``step``: ``tick/pack``, ``tick/launch``,
  ``tick/wait`` (the previous tick's log copy), ``tick/deliver``.
* ``ops/beamsearch.py`` ``traceback``: ``traceback/copy`` and
  ``traceback/walk``.  With the logs on a card: the walk kernel
  (``ops/traceback.py``) and the copy of its paths to the host, then the
  host's reversal and label lookups.  With the logs on the host: the
  state, logs and snapshots to the host, then the walk.
* ``utils/cuda_graphs.py``: ``capture`` (a graph's first call and
  capture).
* ``models/nnet.py``: ``am/forward`` (a ``GraphedAm`` call: the copy in,
  the replay and the outputs' clones; on the card it ends at the launch,
  not at the device's end).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from threading import get_ident
from time import perf_counter
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_RANGE = nullcontext()

# a served push records ~17 spans: a flood of 200 pushes a second for 48 s
# records ~165,000 (a traced flood run on an H100 recorded 107,303 in
# 51 s); a full ring holds ~120 MB of host memory (~230 bytes a span)
SPAN_CAPACITY = 1 << 19


def scope(name: str):
    """Named range for device code: the ops launched inside it are grouped
    under ``name`` in a trace (``with scope("search/emit"): ...``).  With no
    profiler recording it is a no-op, so the search's hot path pays no
    dispatcher call for it, as JAX's ``named_scope`` costs nothing at run
    time."""
    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return record_function(name)


class Span(NamedTuple):
    """One timed block (``perf_counter`` seconds)."""
    name: str
    thread: int                 # threading.get_ident()
    start: float
    end: float
    req: object                 # the request it served, or None
    parent: str | None          # the enclosing span's name, or None


class SpanRing:
    """The last ``capacity`` spans recorded, from any thread (kept as plain
    tuples, read back as ``Span``)."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.evicted = 0                       # spans overwritten
        self._buf: list[tuple | None] = [None] * capacity
        self._n = 0
        self._evicted_end = float("-inf")
        self._lock = threading.Lock()

    def add(self, s: tuple) -> None:
        """Record ``s``, a tuple of ``Span``'s fields."""
        with self._lock:
            i = self._n % self.capacity
            old = self._buf[i]
            if old is not None:
                self.evicted += 1
                if old[3] > self._evicted_end:
                    self._evicted_end = old[3]
            self._buf[i] = s
            self._n += 1

    def spans(self, t0: float = float("-inf"),
              t1: float = float("inf")) -> list[Span]:
        """The spans with ``t0 <= start`` and ``end <= t1``, by start."""
        with self._lock:
            buf = list(self._buf)
        return sorted((Span._make(s) for s in buf if s is not None
                       and t0 <= s[2] and s[3] <= t1), key=lambda s: s.start)

    def lost(self, t0: float) -> bool:
        """Whether a span that ended at or after ``t0`` was overwritten."""
        return self._evicted_end >= t0


RING = SpanRing()

# (name, req) of the innermost open span of this thread or asyncio task
_open: ContextVar[tuple | None] = ContextVar("asr_span", default=None)


class span:
    """``with span("device/push", req): ...`` records the block's interval
    into ``RING`` (module docstring); ``.start``, ``.end`` and ``.seconds``
    read it once the block has ended."""

    __slots__ = ("name", "req", "start", "end", "_parent", "_token",
                 "_range")

    def __init__(self, name: str, req=None):
        self.name = name
        self.req = req

    def __enter__(self) -> span:
        outer = _open.get()
        self._parent = None
        if outer is not None:
            self._parent = outer[0]
            if self.req is None:
                self.req = outer[1]
        self._token = _open.set((self.name, self.req))
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open.reset(self._token)
        RING.add((self.name, get_ident(), self.start, self.end, self.req,
                  self._parent))

    @property
    def seconds(self) -> float:
        return self.end - self.start


def record(name: str, start: float, end: float, req=None) -> None:
    """A span timed by the caller (a wait that began elsewhere: a queue's
    submit to its start), under the enclosing span as ``span`` records."""
    outer = _open.get()
    if outer is not None and req is None:
        req = outer[1]
    RING.add((name, get_ident(), start, end, req,
              outer[0] if outer is not None else None))


def spans(t0: float = float("-inf"), t1: float = float("inf")) -> list[Span]:
    """The recorded spans that lie inside ``[t0, t1]``, by start."""
    return RING.spans(t0, t1)


def lost(t0: float) -> bool:
    """Whether the ring overwrote a span that ended at or after ``t0``:
    then ``spans(t0, ...)`` is incomplete."""
    return RING.lost(t0)


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
