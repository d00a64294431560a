"""Device mesh and sharding utilities, in one process.

Port of ``asr_decoder_tpu/parallel/mesh.py``.  The JAX package maps the
reference's parallelism (SURVEY §2.10) onto a ``jax.sharding.Mesh``:
request-level data parallelism (the thread pool, ref:
src/service2/thread-pool.h) becomes utterance-batch data parallelism over
the ``dp`` axis, and model sharding — absent in the reference, whose nnets
are CPU-sized — is the ``tp`` axis over wide projections.  XLA then
partitions one program over the mesh.

PyTorch has no single-process SPMD partitioner, so the port spells the
layout out:

  * ``Mesh`` is a ``(dp, tp)`` grid of ``torch.device``s; row ``i`` is dp
    block ``i``, its first device the one that owns the block's rows.  The
    grid may repeat a device (``["cuda:0"] * 4`` on a one-card machine).
  * A batch-leading array is dp-sharded into contiguous row blocks, exactly
    as ``P("dp")`` places rows: block ``i`` holds rows
    ``[i·B/dp, (i+1)·B/dp)`` (``data_sharding``, ``shard_batch``,
    ``gather_batch``).
  * ``shard_model`` keeps JAX's ``_layer_param_spec`` layout: affine and
    linear weight rows, and the affine bias, split over tp in contiguous
    blocks (``TpAffine``); every other parameter replicated (recurrent
    weights carry the time scan's dependencies).  Where XLA inserts an
    all-gather after a tp-split layer, ``TpAffine`` computes its row blocks
    on the row's tp devices and concatenates them, in block order, on the
    dp device.  ``am_forward`` runs each dp block's layer list unchanged.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

TP_KINDS = ("affine", "linear")


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare ``cuda`` pinned to the current
    card so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``(dp, tp)`` grid of devices: ``devices[i][j]`` is tp shard ``j``
    of dp block ``i``."""

    def __init__(self, devices, tp: int = 1):
        devs = [as_device(d) for d in devices]
        n = len(devs)
        if n == 0 or n % tp:
            raise ValueError(f"{n} devices do not split into tp={tp} rows")
        self.devices = [devs[i * tp:(i + 1) * tp] for i in range(n // tp)]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def dp_devices(self) -> list[torch.device]:
        """The device that owns each dp block's rows."""
        return [row[0] for row in self.devices]


def cuda_devices() -> list[torch.device]:
    """Every CUDA card of this process; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass the mesh's devices "
                           "explicitly (e.g. ['cpu'] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, tp: int = 1) -> Mesh:
    """(dp × tp) mesh over ``devices`` (default: every CUDA card)."""
    return Mesh(cuda_devices() if devices is None else devices, tp=tp)


def data_sharding(mesh: Mesh, batch: int
                  ) -> list[tuple[slice, torch.device]]:
    """The rows of each dp block of a ``batch``-row array, with the device
    that holds them: block ``i`` = rows ``[i·B/dp, (i+1)·B/dp)``."""
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by dp={dp}")
    n = batch // dp
    return [(slice(i * n, (i + 1) * n), d)
            for i, d in enumerate(mesh.dp_devices)]


def shard_batch(mesh: Mesh, *arrays):
    """Batch-leading arrays (numpy or tensors) dp-sharded: for each, the
    list of its dp blocks, each on its block's device."""
    outs = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a
        outs.append([t[rows].to(d) for rows, d in
                     data_sharding(mesh, t.shape[0])])
    return tuple(outs) if len(outs) > 1 else outs[0]


def gather_batch(blocks, device) -> torch.Tensor:
    """The dp blocks of one array joined in block order on ``device``."""
    return torch.cat([b.to(device) for b in blocks])


def replicate_layers(layers, device) -> list:
    """``layers`` on ``device``: the same modules when they already live
    there (no second upload), else copies moved there."""
    device = as_device(device)
    params = [p for l in layers for p in l.parameters()]
    if all(as_device(p.device) == device for p in params):
        return list(layers)
    return [copy.deepcopy(l).to(device) for l in layers]


class TpAffine(nn.Module):
    """An affine or linear layer with its weight rows (and the affine bias)
    split in ``tp`` contiguous blocks, block ``j`` held on tp device ``j``
    (JAX ``P("tp", None)`` / ``P("tp")``).  ``forward`` computes block
    ``j`` of output columns on ``devices[j]`` (the calling dp block's tp
    devices) and concatenates them, in block order, on the input's device;
    gradients flow back through the copies."""

    def __init__(self, layer: nn.Module, devices):
        super().__init__()
        self.kind, self.meta = layer.kind, layer.meta
        self.input_dim, self.output_dim = layer.input_dim, layer.output_dim
        self.devices = [as_device(d) for d in devices]
        tp = len(self.devices)

        def blocks(p):
            return nn.ParameterList(
                nn.Parameter(b.detach().clone().to(d), requires_grad=False)
                for b, d in zip(torch.tensor_split(p, tp, dim=0),
                                self.devices))
        self.weight = blocks(layer.weight)
        self.bias = blocks(layer.bias) if layer.kind == "affine" else None

    def init_state(self, batch: int, device=None) -> dict:
        return {}

    def forward(self, x, state, devices):
        outs = []
        for j, d in enumerate(devices):
            y = torch.matmul(x.to(d), self.weight[j].to(d).t())
            if self.bias is not None:
                y = y + self.bias[j].to(d)
            outs.append(y.to(x.device))
        return torch.cat(outs, dim=-1), state

    def full(self, name: str) -> torch.Tensor:
        """The unsplit ``weight`` or ``bias``, joined on tp device 0."""
        return gather_batch(getattr(self, name), self.devices[0])


class _OnRow(nn.Module):
    """A layer of a sharded model run by one dp block: its parameters are
    read on the block's devices (a copy where they live elsewhere, through
    which gradients flow back) and its input moves to the block's dp
    device."""

    def __init__(self, layer: nn.Module, devices: list[torch.device]):
        super().__init__()
        self.layer = layer
        self.devices = devices
        self.kind, self.meta = layer.kind, layer.meta
        self.input_dim, self.output_dim = layer.input_dim, layer.output_dim

    def init_state(self, batch: int, device=None) -> dict:
        return self.layer.init_state(batch, self.devices[0])

    def forward(self, x, state):
        d = self.devices[0]
        if isinstance(self.layer, TpAffine):
            return self.layer(x.to(d), state, self.devices)
        params = {n: p.to(d) for n, p in self.layer.named_parameters()}
        return functional_call(self.layer, params, (x.to(d), state))


class ShardedModel(nn.Module):
    """A layer list placed on a mesh by ``shard_model``: ``layers`` holds
    each parameter once (tp blocks on dp block 0's tp devices, the rest on
    its dp device); ``rows[i]`` is the layer list dp block ``i`` runs
    through ``am_forward``."""

    def __init__(self, mesh: Mesh, layers):
        super().__init__()
        self.mesh = mesh
        home = mesh.devices[0]
        self.layers = nn.ModuleList(
            TpAffine(l, home) if l.kind in TP_KINDS
            else copy.deepcopy(l).to(home[0]) for l in layers)
        # plain lists: the row views share the layers' parameters
        self.rows = [[_OnRow(l, row) for l in self.layers]
                     for row in mesh.devices]

    def init_state(self, batch: int) -> list[list[dict]]:
        """Zero streaming state of a ``batch``-row array, per dp block."""
        return [[l.init_state(rows.stop - rows.start) for l in row]
                for row, (rows, _) in zip(self.rows,
                                          data_sharding(self.mesh, batch))]

    def unsharded(self) -> dict[str, torch.Tensor]:
        """Every parameter, tp blocks joined, under the name it has in the
        unsharded ``Nnet`` (``layers.<i>.<name>``)."""
        out = {}
        for i, l in enumerate(self.layers):
            if isinstance(l, TpAffine):
                for name in ("weight", "bias")[:1 + (l.bias is not None)]:
                    out[f"layers.{i}.{name}"] = l.full(name)
            else:
                for name, p in l.named_parameters():
                    out[f"layers.{i}.{name}"] = p
        return out


def shard_model(mesh: Mesh, layers) -> ShardedModel:
    """Place a layer list onto the mesh with tp-split affine/linear rows
    and everything else replicated (JAX ``_layer_param_spec``); the input
    layers are copied, not moved."""
    return ShardedModel(mesh, layers)


def sharded_forward(model: ShardedModel, x, state=None, **am_kw):
    """``am_forward`` over a dp-sharded batch: ``x`` [B, T, D] (or its dp
    blocks) → (the dp blocks of the log-likelihoods, each block's new
    state).  ``state``: per-block states (``model.init_state``), zero when
    None."""
    from asr_decoder_tpu_torch.models.nnet import am_forward
    mesh = model.mesh
    blocks = x if isinstance(x, list) else shard_batch(mesh, x)
    if state is None:
        state = model.init_state(sum(b.shape[0] for b in blocks))
    outs = [am_forward(row, xb, st, **am_kw)
            for row, xb, st in zip(model.rows, blocks, state)]
    return [y for y, _ in outs], [st for _, st in outs]
