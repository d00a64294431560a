"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs a chunk of frames as one compiled device program
(``lax.scan`` over a jitted frame step, cached by the static config and the
array shapes).  PyTorch runs eagerly, so every op of a search frame or an
AM chunk would be a host launch; here the work is captured once as a
``torch.cuda.CUDAGraph`` and replayed.

``GraphRunner`` owns the capture, the static buffers and the replay of one
callable for one static key: its owner keeps one runner a key (shapes,
dtypes, device, static config), as the JAX jit cache does.  The callable
takes the buffers (any object holding tensors), reads and writes them in
place and may return tensors, the static outputs, which every replay
overwrites — a caller that keeps a result clones it.

  * On a CUDA device the first call runs the callable eagerly as the real
    call (that builds and loads the kernels and lets the libraries set
    up), then captures it, which runs nothing; every later call is one
    replay, on the caller's current stream.  A capture that fails raises
    with the op's error: there is no eager fallback and no switch that
    turns the graphs off.
  * On the CPU, which only tests and ``--device cpu`` ask for, every call
    runs the callable on the same static buffers, so the CPU tests
    exercise the buffer handling that the card replays.
  * A ``GraphRunner`` serves inference and refuses to run with autograd
    on: its body builds no backward.  A ``TrainingGraphRunner`` runs a
    body that calls its own ``backward()`` and optimizer step (the CTC
    training step), with autograd on: its first call is the real first
    step, run eagerly on a side stream (the warm-up of PyTorch's
    whole-network capture recipe; it also creates the optimizer's state),
    then the capture records the forward, the backward and the update.
    Gradients made under ``zero_grad(set_to_none=True)`` inside the
    capture live in the graph's memory pool: the runner copies the first
    step's gradients into them, and every replay rewrites them.

An owner keys its runners with ``static_key`` of the inputs, makes the
runner's buffers with ``static_buffers`` and fills them with ``copy_into``:
one copy call for each dtype (``torch._foreach_copy_``), so a replay costs
the host a few calls.

Launch counters.  The kernel wrappers (``ops/gather.py``, ``ops/fetch.py``)
count their launches in Python, which a capture runs once and a replay
never.  ``LaunchCounts`` takes each counter's change during a capture back
and adds it again at every replay, with the launch shapes the capture
recorded, so the counts read as those of the eager run of the same work.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from asr_decoder_tpu_torch.utils.profiling import span


def _counted_modules() -> tuple:
    from asr_decoder_tpu_torch.ops import fetch, gather
    return (gather, fetch)


class LaunchCounts:
    """The launch counts (``launches`` and the ``shapes`` set, which is None
    while nobody records) of ``modules`` that one captured graph makes at
    each replay."""

    def __init__(self, modules=None):
        self.modules = tuple(_counted_modules() if modules is None
                             else modules)
        self.launches = [0] * len(self.modules)
        self.shapes: list[set] = [set() for _ in self.modules]

    @contextmanager
    def capture(self):
        """Record each counter's change inside the block, then restore the
        counters: the block launched nothing."""
        before = [m.launches for m in self.modules]
        saved = [m.shapes for m in self.modules]
        for m in self.modules:
            m.shapes = set()
        try:
            yield
        finally:
            for i, m in enumerate(self.modules):
                self.launches[i] = m.launches - before[i]
                self.shapes[i] = m.shapes
                m.launches, m.shapes = before[i], saved[i]

    def replay(self) -> None:
        """Add one replay's launches (and shapes, where recorded)."""
        for m, n, shapes in zip(self.modules, self.launches, self.shapes):
            m.launches += n
            if m.shapes is not None:
                m.shapes |= shapes


class GraphRunner:
    """``body(buffers)`` as one captured CUDA graph on ``device``, or
    called directly on the CPU (module docstring).  A caller
    holds ``lock`` from filling the buffers to reading the results: the
    buffers are shared by every caller of the runner.  ``pool``: a
    ``torch.cuda.graph_pool_handle()`` the capture shares with other
    runners (their owner keeps any two from running at once), else the
    graph keeps a pool of its own."""

    def __init__(self, body, buffers, device: torch.device, pool=None):
        self.body = body
        self.buffers = buffers
        self.device = torch.device(device)
        self.pool = pool
        self.lock = threading.Lock()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.counts = LaunchCounts()
        self._outputs = None

    def __call__(self):
        if torch.is_grad_enabled():
            raise RuntimeError("an inference graph records no backward: run "
                               "it under torch.inference_mode() or "
                               "torch.no_grad()")
        return self._run()

    def _run(self):
        if self.device.type != "cuda":
            return self._eager()
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        self.counts.replay()
        return self._outputs

    def _eager(self):
        """The body on the buffers, uncaptured: the CPU path (and, on the
        card, the eager side of ``chip_smoke.py``'s graph-vs-eager A/B)."""
        return self.body(self.buffers)

    def _first_call(self):
        return self._eager()

    def _capture(self):
        """The first call: run eagerly, then capture (``torch.cuda.graph``
        waits for the eager run and captures on a stream of its own); the
        two are the span ``capture``."""
        with span("capture"), torch.cuda.device(self.device):
            out = self._first_call()
            graph = torch.cuda.CUDAGraph()
            with self.counts.capture(), torch.cuda.graph(graph,
                                                         pool=self.pool):
                self._outputs = self.body(self.buffers)
        self.graph = graph
        return out


class TrainingGraphRunner(GraphRunner):
    """``body(buffers)`` that runs its own backward and optimizer step over
    ``params``, one captured CUDA graph on ``device`` (module docstring).
    It runs with autograd on; its optimizer must be ``capturable`` on the
    card (a capture of a non-capturable ``torch.optim.Adam`` raises)."""

    def __init__(self, body, buffers, device: torch.device, params: list):
        super().__init__(body, buffers, device)
        self.params = params

    def __call__(self):
        with torch.enable_grad():
            return self._run()

    def _first_call(self):
        """The real first step, on a side stream (the warm-up of PyTorch's
        whole-network capture recipe)."""
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._eager()
        current.wait_stream(side)
        self._first_grads = [p.grad for p in self.params]
        for t in [out, *self._first_grads]:
            if t is not None:
                t.record_stream(current)
        return out

    def _capture(self):
        """The first step and the capture, which leaves each ``.grad`` a
        buffer of the graph's pool that nothing has written: the first
        step's gradients go into them."""
        out = super()._capture()
        pairs = [(p.grad, g) for p, g in zip(self.params, self._first_grads)
                 if g is not None]
        copy_into([d for d, _ in pairs], [g for _, g in pairs])
        self._first_grads = None
        return out


def static_key(inputs) -> tuple:
    """The nest of tensors, lists, tuples and dicts ``inputs`` as a hashable
    key: its structure, dict keys, and each tensor's shape and dtype."""
    if isinstance(inputs, torch.Tensor):
        return tuple(inputs.shape), inputs.dtype
    if isinstance(inputs, dict):
        return tuple((k, static_key(v)) for k, v in inputs.items())
    return tuple(static_key(v) for v in inputs)


def static_buffers(inputs, device: torch.device):
    """Empty tensors of the shapes and dtypes of ``inputs`` on ``device``,
    in the same nest."""
    if isinstance(inputs, torch.Tensor):
        return torch.empty(inputs.shape, dtype=inputs.dtype, device=device)
    if isinstance(inputs, dict):
        return {k: static_buffers(v, device) for k, v in inputs.items()}
    return type(inputs)(static_buffers(v, device) for v in inputs)


def _leaves(inputs) -> list:
    if isinstance(inputs, torch.Tensor):
        return [inputs]
    values = inputs.values() if isinstance(inputs, dict) else inputs
    return [t for v in values for t in _leaves(v)]


def copy_into(dst, src) -> None:
    """``d.copy_(s)`` for each pair of tensors of the two nests (of one
    structure), one ``torch._foreach_copy_`` call for each dtype."""
    groups: dict = {}
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)
