"""Worker process of the multi-process ``torch.distributed`` selftest.

Port of ``asr_decoder_tpu/parallel/_mh_worker.py``.  Run as ``python -m
asr_decoder_tpu_torch.parallel._mh_worker <coordinator> <num_processes>
<process_id> [gloo|nccl] [timeout_s]``: joins the rendezvous (``gloo``
ranks on the CPU, ``nccl`` rank ``r`` on card ``r``), builds the global
(dp × tp) ``DeviceMesh`` (tp = 2 when the rank count is even), runs the
tp-sharded AM — affine rows split over the tp group and joined with
``all_gather`` — on its own dp block of a global batch, and checks it
against the unsharded forward that every rank computes locally
(``rtol = atol = 1e-5``, as JAX).  Then a cross-process check: the finite
count of the sharded output, summed over the job with ``all_reduce``,
equals the reference's.  Prints ``MH_OK`` on success (the spawner reads
it).  ``run_distributed_selftest`` in ``multihost.py`` spawns it.
"""

from __future__ import annotations

import sys


def main(coordinator: str, num_processes: int, process_id: int,
         backend: str = "gloo", timeout: float = 120.0) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from asr_decoder_tpu_torch.models.layers import (make_affine,
                                                     make_lstm_projected)
    from asr_decoder_tpu_torch.models.nnet import Nnet, am_forward
    from asr_decoder_tpu_torch.parallel.multihost import (global_mesh,
                                                          init_multihost,
                                                          shard_model_ranks)

    if backend == "nccl":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    ctx = init_multihost(coordinator, num_processes, process_id,
                         backend=backend, timeout=timeout)
    try:
        assert dist.get_world_size() == num_processes
        mesh = global_mesh(ctx, tp=2 if num_processes % 2 == 0 else 1)
        dp, tp = mesh.shape
        dp_rank, tp_rank = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")

        gen = torch.Generator().manual_seed(0)     # same seed on every rank
        D, H, P_, V = 16, 32, 24, 40
        net = Nnet([make_lstm_projected(gen, D, H, P_),
                    make_affine(gen, P_, V)]).to(device)
        rng = np.random.default_rng(0)
        B, T = 8, 12
        feats = torch.from_numpy(
            (rng.standard_normal((B, T, D)) * 2).astype(np.float32)).to(device)

        with torch.inference_mode():
            # local unsharded reference (every rank computes the same thing)
            ll0, _ = am_forward(net.layers, feats, net.init_state(B, device))
            n = B // dp
            rows = slice(dp_rank * n, (dp_rank + 1) * n)
            layers = shard_model_ranks(mesh, net.layers)
            ll1, _ = am_forward(layers, feats[rows],
                                [l.init_state(n, device) for l in layers])
        np.testing.assert_allclose(ll1.cpu().numpy(), ll0[rows].cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)

        # a cross-process check over the global sharded output: each dp
        # block counted once (by its tp rank 0), summed over every rank
        tot = torch.isfinite(ll1).sum() if tp_rank == 0 else \
            torch.zeros((), dtype=torch.int64, device=device)
        tot = tot.to(torch.int64).reshape(1)
        dist.all_reduce(tot)
        want = int(torch.isfinite(ll0).sum())
        assert int(tot) == want, (int(tot), want)
        print(f"MH_OK process={process_id}/{num_processes} backend={backend} "
              f"device={device} mesh=dp{dp}xtp{tp} block={dp_rank}.{tp_rank}",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         *(sys.argv[4:5]), *(float(a) for a in sys.argv[5:6]))
