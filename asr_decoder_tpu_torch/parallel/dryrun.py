"""Dry run of the port: a one-device forward step and a multi-device check.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

  * ``entry()`` — the flagship's forward step, fbank frontend + streaming
    projected-LSTM AM, as a function and its example input;
  * ``dryrun_multichip(n)`` — over an n-device (dp × tp) mesh
    (``parallel/mesh.py``; tp = 2 when n is even): one CTC training step
    of the flagship with its affine rows tp-split and the batch dp-split,
    held to the unsharded ``ctc_train_step``; a dp-sharded decode that
    must equal the single-device decode; tp-sharded AM inference within
    ``TP_AM_TOL`` of the unsharded AM; and the per-host-arena skeleton
    (two simulated hosts, each with its own dp mesh).

Run it as ``python -m asr_decoder_tpu_torch.parallel.dryrun [--device
cpu]``: ``entry()``, then ``dryrun_multichip(4)``; on the CPU the mesh
repeats the CPU device, on the card it takes the CUDA cards round-robin,
so one card plays every device.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

TP_AM_TOL = 1e-4      # max abs err of the tp-sharded AM's log-likelihoods
TRAIN_TOL = 1e-3      # updated parameters, by name (one Adam step at lr 1e-3)
LOSS_RTOL = 1e-4      # sharded loss against the unsharded one, relative


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model — fbank
    frontend + streaming projected-LSTM AM posteriors."""
    from asr_decoder_tpu_torch.frontend.fbank import FbankConfig, compute_fbank
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    from asr_decoder_tpu_torch.models.nnet import am_forward

    cfg = FbankConfig(num_bins=80)
    nnet = make_flagship(0, feat_dim=80, num_pdfs=512, hidden=256, proj=128,
                         num_layers=2, device=device)
    batch = 2
    state = nnet.init_state(batch, device)

    @torch.inference_mode()
    def fn(wave):
        feats = compute_fbank(cfg, wave)
        loglikes, _ = am_forward(nnet.layers, feats, state, skip=2)
        return loglikes

    wave = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (batch, 16000)) * 1000).astype(np.float32)).to(device)
    return fn, (wave,)


def sharded_ctc_train_step(model, opt: torch.optim.Adam, x, labels,
                           label_paddings) -> torch.Tensor:
    """One Adam CTC step of a ``ShardedModel`` in place: each dp block's
    loss (``models/flagship.py:ctc_loss_fn``) on its device, the blocks'
    losses summed and divided by the whole batch B — the unsharded step's
    mean — with gradients flowing back through every cross-device copy
    and tp concatenation.  ``opt`` is ``init_opt_state(model)``.  Returns
    the loss before the update, on dp device 0."""
    from asr_decoder_tpu_torch.models.flagship import ctc_loss_fn
    from asr_decoder_tpu_torch.parallel.mesh import shard_batch
    mesh = model.mesh
    home = mesh.dp_devices[0]
    B = len(x)
    with torch.enable_grad():
        model.requires_grad_(True)
        opt.zero_grad(set_to_none=True)
        parts = [ctc_loss_fn(row, xb, lb, pb, st) * xb.shape[0]
                 for row, xb, lb, pb, st in zip(
                     model.rows, *shard_batch(mesh, x, labels, label_paddings),
                     model.init_state(B))]
        loss = torch.stack([p.to(home) for p in parts]).sum() / B
        loss.backward()
        opt.step()
    return loss.detach()


def train_check(mesh, nnet, x, labels, label_paddings) -> dict:
    """One CTC step of ``nnet`` sharded over ``mesh`` and one of an
    unsharded copy on the same batch: the losses and every updated
    parameter (by name) must agree.  ``nnet`` is left as it was."""
    from asr_decoder_tpu_torch.models.flagship import (ctc_train_step,
                                                       init_opt_state)
    from asr_decoder_tpu_torch.parallel.mesh import shard_model
    home = mesh.dp_devices[0]
    model = shard_model(mesh, nnet.layers)
    loss = float(sharded_ctc_train_step(model, init_opt_state(model), x,
                                        labels, label_paddings))
    ref = copy.deepcopy(nnet)
    t = [torch.as_tensor(a).to(home) for a in (x, labels, label_paddings)]
    ref_loss = float(ctc_train_step(ref, init_opt_state(ref), *t,
                                    ref.init_state(len(x), home)))
    got = model.unsharded()
    want = dict(ref.named_parameters())
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    err = max(float((got[k].detach().to(home) - want[k].detach()).abs().max())
              for k in want)
    assert np.isfinite(loss) and abs(loss - ref_loss) <= LOSS_RTOL * abs(
        ref_loss), (loss, ref_loss)
    assert err <= TRAIN_TOL, err
    return dict(loss=loss, ref_loss=ref_loss, param_err=err)


def train_inputs(dp: int, device, feat_dim: int = 8, num_pdfs: int = 32):
    """The training step's tiny flagship (seed 0) and batch (B = 2·dp, T =
    12, 6 labels, from ``np.random.default_rng(0)``), and the generator
    the rest of the dry run draws from."""
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    B, T, N = dp * 2, 12, 6
    nnet = make_flagship(0, feat_dim=feat_dim, num_pdfs=num_pdfs, hidden=16,
                         proj=8, num_layers=2, device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, feat_dim)).astype(np.float32)
    labels = rng.integers(1, num_pdfs, (B, N)).astype(np.int32)
    return nnet, x, labels, np.zeros((B, N), np.float32), rng


def _same_paths(got: list, want: list) -> None:
    assert [(r["words"], r["arc_ids"], r["cost"]) for r in got] == \
        [(r["words"], r["arc_ids"], r["cost"]) for r in want]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The multi-device dry run over ``n_devices`` of ``devices`` (default:
    the CUDA cards round-robin; raises without one).  Returns what each
    part measured."""
    from asr_decoder_tpu_torch.decoder.config import DecoderConfig
    from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
    from asr_decoder_tpu_torch.fst.synthetic import random_hclg
    from asr_decoder_tpu_torch.models.flagship import make_flagship
    from asr_decoder_tpu_torch.models.nnet import am_forward
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    from asr_decoder_tpu_torch.parallel.decode import dp_decode
    from asr_decoder_tpu_torch.parallel.mesh import (cuda_devices,
                                                     gather_batch, make_mesh,
                                                     shard_model,
                                                     sharded_forward)
    from asr_decoder_tpu_torch.parallel.multihost import (init_multihost,
                                                          partition_hosts)
    if devices is None:
        cards = cuda_devices()
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(devices, tp=tp)
    dp = mesh.shape["dp"]
    home = mesh.dp_devices[0]
    out = {"mesh": mesh.shape}

    # one CTC training step over the mesh
    nnet, x, labels, label_paddings, rng = train_inputs(dp, home)
    (B, T, feat_dim), num_pdfs = x.shape, nnet.output_dim
    out["train"] = train_check(mesh, nnet, x, labels, label_paddings)
    print(f"dryrun_multichip: mesh={mesh.shape} ctc_loss="
          f"{out['train']['loss']:.4f} (unsharded "
          f"{out['train']['ref_loss']:.4f}; updated parameters within "
          f"{out['train']['param_err']:.2e})")

    # dp-sharded decode: graph replicated, loglikes and beam dp-sharded
    fst = random_hclg(rng, num_states=300, num_ilabels=num_pdfs - 1,
                      num_words=50, max_degree=4)
    dev = DeviceFst.build(fst, arc_lanes=8)
    i2p = np.arange(num_pdfs, dtype=np.int32)
    search = TorchBeamSearch(dev, i2p, DecoderConfig(
        beam_width=32, arc_lanes=8, min_active=0), device=home)
    lls = rng.standard_normal((dp * 2, T, num_pdfs)).astype(np.float32)
    want = search.traceback(*search.decode(lls), fst)
    _same_paths(search.traceback(*dp_decode(mesh, search, lls), fst), want)
    out["best_cost"] = want[0]["cost"]
    print(f"dryrun_multichip: dp decode parity ok on {dp} dp blocks "
          f"(B={len(lls)}, best_cost={want[0]['cost']:.3f})")

    # tp-sharded AM inference: posteriors must match the unsharded AM
    nnet2 = make_flagship(1, feat_dim=feat_dim, num_pdfs=num_pdfs,
                          hidden=16, proj=8, num_layers=2, device=home)
    x_inf = torch.from_numpy(rng.standard_normal(
        (B, T, feat_dim)).astype(np.float32)).to(home)
    with torch.inference_mode():
        ll_ref, _ = am_forward(nnet2.layers, x_inf, nnet2.init_state(B, home))
        blocks, _ = sharded_forward(shard_model(mesh, nnet2.layers), x_inf)
    out["tp_am_err"] = float((gather_batch(blocks, home) - ll_ref).abs()
                             .max())
    assert out["tp_am_err"] < TP_AM_TOL, out["tp_am_err"]
    print(f"dryrun_multichip: tp-sharded AM inference parity ok (tp={tp}, "
          f"max|Δ|={out['tp_am_err']:.2e})")

    # multi-host serving skeleton: 2 simulated hosts as disjoint device
    # groups, each with its own dp mesh, decoding its own rows
    ctx = init_multihost()
    groups = partition_hosts(devices, 2 if n_devices % 2 == 0 else 1)
    lo = 0
    for g in groups:
        m = make_mesh(g, tp=1)
        hi = lo + m.shape["dp"]
        _same_paths(search.traceback(*dp_decode(m, search, lls[lo:hi]),
                                     fst), want[lo:hi])
        lo = hi
    out["hosts"] = len(groups)
    print(f"dryrun_multichip: multihost skeleton ok ({len(groups)} "
          f"simulated hosts × {len(groups[0])} devices, process "
          f"{ctx.process_id}/{ctx.num_processes})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    y = fn(*example)
    print(f"entry ok: {tuple(y.shape)} {y.dtype}")
    dryrun_multichip(4, None if args.device == "cuda" else ["cpu"] * 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
