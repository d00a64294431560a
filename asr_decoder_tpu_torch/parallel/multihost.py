"""Multi-host serving skeleton (BASELINE config 5: pod-slice serving).

Port of ``asr_decoder_tpu/parallel/multihost.py`` to ``torch.distributed``.
The reference scales serving with one pthread pool per CPU node behind an
external balancer (ref: src/service2/thread-pool.h:33, --nthread=60..800,
src/v2-asrbin/conf/v2-conf.txt); a multi-card deployment re-expresses that
as one process per host, each owning the host's cards.

Architecture (and why dp serving needs no cross-host collective):
``parallel/decode.py``'s dp decode runs no collective — the graph is
replicated and every utterance lives on exactly one card — so a cluster
serves as N *independent* per-host arenas: each host runs its own
``AsrServer`` + ``BatchedStreamingDecoder`` over a host-local (dp × tp)
mesh (``local_serving_mesh``) and its own TCP ingress port, with client
traffic spread by any L4 balancer.  A process group is only needed when one
model spans hosts — a tp-sharded AM too large for one host's cards — and
then ``global_mesh`` is a ``torch.distributed`` ``DeviceMesh`` with one
rank per device, AM weight rows split over ``tp`` and the batch over
``dp``; the tp blocks are joined with ``all_gather`` (``_mh_worker``).

Host-loss behavior: with per-host arenas (the default), losing a host
loses only that host's in-flight channels — the balancer redirects new
streams to surviving hosts, and reconnecting clients resend from their
last unacknowledged chunk (every C2S package gets an S2C reply).  With a
cross-host process group, a lost rank stalls the collectives until the
group's ``timeout`` and the job must be restarted — which is why serving
defaults to per-host isolation and keeps the global mesh for oversized
AMs.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from torch import nn

from asr_decoder_tpu_torch.parallel.mesh import (TP_KINDS, cuda_devices,
                                                 make_mesh)

DEFAULT_TIMEOUT_S = 120.0


@dataclass
class MultihostContext:
    """Process-level topology handle."""
    num_processes: int
    process_id: int
    coordinator: str | None
    backend: str | None = None

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int = 1, process_id: int = 0,
                   backend: str | None = None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> MultihostContext:
    """Join the cross-host process group.

    One process with no coordinator (the per-host-arena default) is a
    no-op; more processes need the coordinator's address.  Otherwise
    ``init_process_group`` connects this process to the coordinator
    (``host:port`` or ``tcp://host:port``) with ``backend`` (``nccl``, the
    default, for cards; ``gloo`` for the CPU, only when the caller passes
    it: with no visible card ``nccl`` raises ``RuntimeError`` before any
    process group is made, so a job whose card is missing never carries on
    over CPU collectives) and an explicit ``timeout`` in seconds, so that a
    lost rank fails the collectives instead of hanging them."""
    if coordinator_address is None:
        if num_processes == 1:
            return MultihostContext(1, 0, None)
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address")
    import torch.distributed as dist
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: backend 'nccl' needs a visible "
                           "CUDA device and none is; on the CPU pass "
                           "backend=\"gloo\"")
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(
        backend, init_method=addr, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return MultihostContext(num_processes, process_id, addr, backend)


def local_serving_mesh(tp: int = 1, devices=None):
    """Per-host (dp × tp) mesh over this process's devices (default: every
    CUDA card; raises when there is none) — the default serving topology
    (an independent arena per host)."""
    return make_mesh(devices, tp=tp)


def global_mesh(ctx: MultihostContext, tp: int = 1, devices=None):
    """Cross-host (dp × tp) mesh over every device of the job, one rank
    per device: a ``torch.distributed`` ``DeviceMesh`` with dims
    ``("dp", "tp")`` once ``init_multihost`` has joined a process group.
    In a single process it is the local mesh over ``devices``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if ctx.num_processes > 1:
            raise RuntimeError(
                f"torch.distributed is not initialized for "
                f"{ctx.num_processes} processes; call init_multihost with "
                "the coordinator address first")
        return make_mesh(devices, tp=tp)
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"world size {world} does not split into tp={tp}")
    return init_device_mesh("cuda" if ctx.backend == "nccl" else "cpu",
                            (world // tp, tp), mesh_dim_names=("dp", "tp"))


class RankTpAffine(nn.Module):
    """An affine or linear layer of a model sharded over ranks: this rank
    holds row block ``rank`` of ``tp`` of the weight (and of the affine
    bias); ``forward`` computes its block of output columns and joins the
    blocks of the tp group, in rank order, with ``all_gather``."""

    def __init__(self, layer: nn.Module, group):
        super().__init__()
        import torch.distributed as dist
        self.kind, self.meta = layer.kind, layer.meta
        self.input_dim, self.output_dim = layer.input_dim, layer.output_dim
        self.group = group
        tp, rank = dist.get_world_size(group), dist.get_rank(group)
        if layer.output_dim % tp:
            raise ValueError(f"{layer.output_dim} rows do not split into "
                             f"tp={tp} equal blocks")
        self.weight = nn.Parameter(
            layer.weight.detach().chunk(tp)[rank].clone(),
            requires_grad=False)
        self.bias = (nn.Parameter(layer.bias.detach().chunk(tp)[rank].clone(),
                                  requires_grad=False)
                     if layer.kind == "affine" else None)

    def init_state(self, batch: int, device=None) -> dict:
        return {}

    def forward(self, x, state):
        import torch.distributed as dist
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        y = y.contiguous()
        blocks = [torch.empty_like(y)
                  for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(blocks, y, group=self.group)
        return torch.cat(blocks, dim=-1), state


def shard_model_ranks(device_mesh, layers) -> list:
    """This rank's part of a layer list sharded over a global (dp × tp)
    ``DeviceMesh``: affine/linear rows split over the ``tp`` dim
    (``RankTpAffine``), every other layer replicated (the same module)."""
    group = device_mesh.get_group("tp")
    return [RankTpAffine(l, group) if l.kind in TP_KINDS else l
            for l in layers]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_distributed_selftest(num_processes: int = 4,
                             timeout: float = DEFAULT_TIMEOUT_S,
                             backend: str = "gloo") -> list[str]:
    """Spawn ``num_processes`` real OS processes (one rank per device:
    ``gloo`` ranks on the CPU, ``nccl`` ranks on cards ``0..n-1``) that
    each join a local ``torch.distributed`` rendezvous, build the global
    (dp × tp) ``DeviceMesh`` and check the tp-sharded AM on their own dp
    block against the unsharded forward (see ``_mh_worker``).  Returns the
    workers' ``MH_OK`` lines; raises on any worker failure and kills every
    worker still running after ``timeout`` seconds."""
    coord = f"127.0.0.1:{_free_port()}"
    root = str(Path(__file__).resolve().parents[2])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "asr_decoder_tpu_torch.parallel._mh_worker",
         coord, str(num_processes), str(i), backend, str(timeout)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for i in range(num_processes)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            out, _ = p.communicate(timeout=left)
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"distributed selftest: a worker ran past "
                           f"{timeout:g} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    oks = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        ok = [ln for ln in out.splitlines() if ln.startswith("MH_OK")]
        if p.returncode != 0 or not ok:
            raise RuntimeError(
                f"distributed worker {i} failed (rc={p.returncode}):\n"
                + out[-2000:])
        oks.append(ok[0])
    return oks


def partition_hosts(devices, n_hosts: int) -> list[list]:
    """Split a device list into equal per-host groups.  Used to *simulate*
    a multi-host cluster in one process (tests / dry run): each group plays
    the role of one host's local devices."""
    n = len(devices)
    assert n % n_hosts == 0, (n, n_hosts)
    per = n // n_hosts
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_hosts)]


def simulated_host_arenas(info_factory, n_hosts: int, num_channels: int,
                          tp: int = 1, devices=None) -> list:
    """Build ``n_hosts`` independent serving arenas, each over its own
    group of ``devices`` (default: every CUDA card) — the per-host-arena
    topology exercised in one process (a real deployment runs one process
    per host with ``local_serving_mesh``)."""
    from asr_decoder_tpu_torch.serving.batcher import BatchedStreamingDecoder
    devices = cuda_devices() if devices is None else devices
    return [BatchedStreamingDecoder(info_factory(), num_channels,
                                    mesh=make_mesh(g, tp=tp))
            for g in partition_hosts(devices, n_hosts)]
