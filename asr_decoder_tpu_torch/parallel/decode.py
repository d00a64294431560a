"""Data-parallel decode over a device mesh.

Port of ``asr_decoder_tpu/parallel/decode.py``.  Multi-chip serving
(BASELINE config 5, SURVEY §2.10): the reference scales request-level data
parallelism with a pthread pool of independent decoder instances (ref:
src/service2/thread-pool.h:33, --nthread=60..800); the JAX package shards
the utterance batch axis of its one jitted search over the ``dp`` mesh
axis — graph tables replicated on every chip, beam state, loglikes and
frame logs dp-sharded — with no cross-chip collective, since the search is
batch-parallel.

Here each dp block gets a replica of the search (its graph tables, and the
BigLM's LM tables, on the block's device; replicas on one device share one
upload) and decodes its contiguous rows; the replicas are issued one after
another from the calling thread, as the single jitted program is in JAX.
Every search op is row-independent and the BigLM's overflow flag is per
row, so the joined result is bit-identical to the unsharded decode.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from asr_decoder_tpu_torch.parallel.mesh import (Mesh, as_device,
                                                 data_sharding, shard_batch)


def _to(tables, device):
    """A graph-table NamedTuple with its tensors on ``device``."""
    return type(tables)(*(a.to(device) if isinstance(a, torch.Tensor) else a
                          for a in tables))


def replicate_search(search, device):
    """``search`` on ``device``: the search itself when it lives there,
    else a replica (cached on ``search``) whose ``graph``/``pgraph`` tables
    and BigLM ``difflm`` tables are on ``device`` (the read-only shared
    model state, ref: per-thread shared AM/graph in V1AsrSource,
    src/v1-asrbin/v1-asr-service.cc:91-102)."""
    device = as_device(device)
    if as_device(search.device) == device:
        return search
    cache = search.__dict__.setdefault("_replicas", {})
    if device not in cache:
        rep = copy.copy(search)
        rep.device = device
        rep._replicas = {}
        rep._graphs = {}        # its frame runners capture its own tables
        for attr in ("graph", "pgraph"):
            tables = getattr(search, attr, None)
            if tables is not None:
                setattr(rep, attr, _to(tables, device))
        lm = getattr(search, "difflm", None)
        if lm is not None:
            rep.difflm = dataclasses.replace(lm, **{
                k: dataclasses.replace(
                    getattr(lm, k), table=getattr(lm, k).table.to(device),
                    uni=getattr(lm, k).uni.to(device),
                    backoff=getattr(lm, k).backoff.to(device))
                for k in ("lm1", "lm2")})
        cache[device] = rep
    return cache[device]


def shard_search(mesh: Mesh, search) -> list:
    """One search per dp block, on the block's device."""
    return [replicate_search(search, d) for d in mesh.dp_devices]


def shard_beam_state(mesh: Mesh, state) -> list:
    """A batch-leading beam state (``BeamState`` or the BigLM variant) as
    one state per dp block, each on its block's device."""
    blocks = shard_batch(mesh, *state)
    if len(state) == 1:
        blocks = (blocks,)
    return [type(state)(*leaves) for leaves in zip(*blocks)]


def join_rows(parts: list, device, frames: bool):
    """The dp blocks of a state or log (NamedTuples of like leaves) joined
    in row order on ``device``: an init log's leaves are [stages, B, ...]
    (ndim 3) or [B, ...]; a frame log has the frame axis T before either;
    a state's leaves are [B, ...]."""
    def axis(a):
        if frames:
            return 2 if a.ndim >= 4 else 1
        return 1 if a.ndim == 3 else 0
    return type(parts[0])(*(
        torch.cat([p[i].to(device) for p in parts], dim=axis(parts[0][i]))
        for i in range(len(parts[0]))))


def dp_decode(mesh: Mesh, search, loglikes, frame_mask=None):
    """Full-utterance batched decode, dp-sharded over the mesh.

    The contract of ``TorchBeamSearch.decode`` (and the CLG and BigLM
    searches'): returns (final state, init log, frame logs) in the
    unsharded row order on the first dp device, so the host traceback works
    unchanged.  The utterance batch B must divide by the mesh's dp size."""
    B = len(loglikes)
    mask = (np.ones(np.shape(loglikes)[:2], bool) if frame_mask is None
            else np.asarray(frame_mask.cpu() if isinstance(
                frame_mask, torch.Tensor) else frame_mask, bool))
    blocks = shard_batch(mesh, torch.as_tensor(loglikes,
                                               dtype=torch.float32))
    outs = [rep.decode(ll, mask[rows]) for rep, ll, (rows, _) in
            zip(shard_search(mesh, search), blocks, data_sharding(mesh, B))]
    home = mesh.dp_devices[0]
    state, init_log, logs = zip(*outs)
    return (join_rows(state, home, False), join_rows(init_log, home, False),
            join_rows(logs, home, True))
