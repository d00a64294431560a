"""The port's multi-device modules (``asr_decoder_tpu_torch/parallel``) on
the CPU, against the unsharded port and against the JAX package's mesh on
its 8 virtual CPU devices.

Tolerance: none for the port's search — every search op is
row-independent, so a dp-sharded decode is bit-identical to the unsharded
one (every leaf of the state and logs), and so is a dp-sharded arena at
these widths (words, arc ids and costs; at the flagship's widths the AM's
products at B/dp rows round otherwise than at B, which ``chip_smoke.py``
measures).  Against JAX: words and arc ids equal; search
costs equal bit for bit (fp32 adds of the same loglikes), BigLM costs within
1e-5 (XLA contracts ``lm2·c2 − lm1·c1`` into an FMA), costs over the AM's
posteriors within 1e-3 (the AM differs from JAX's in the last bits,
``tests/test_torch_models.py``); the tp-sharded AM within 1e-5 of JAX's,
as in ``tests/test_multichip_decode.py``; the dry run's CTC loss within
1e-4 relative of JAX's ``ctc_train_step`` and its updated parameters
within 1e-3 (``tests/test_torch_train.py``).  The mesh here repeats the
CPU device: ``["cpu"] * 8``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.models.flagship import \
    ctc_train_step as jax_ctc_train_step  # noqa: E402
from asr_decoder_tpu.models.flagship import init_opt_state as jax_opt  # noqa
from asr_decoder_tpu.models.layers import init_layer_state  # noqa: E402
from asr_decoder_tpu.models.nnet import am_forward as jax_am_forward  # noqa
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch  # noqa: E402
from asr_decoder_tpu.parallel.decode import \
    dp_decode as jax_dp_decode  # noqa: E402
from asr_decoder_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from asr_decoder_tpu.parallel.mesh import shard_batch as jax_shard  # noqa
from asr_decoder_tpu.parallel.mesh import \
    shard_model as jax_shard_model  # noqa: E402
from asr_decoder_tpu.serving.batcher import \
    BatchedStreamingDecoder as JaxArena  # noqa: E402
from asr_decoder_tpu_torch.models.nnet import (am_forward,  # noqa: E402
                                               to_numpy_layers)
from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch  # noqa
from asr_decoder_tpu_torch.parallel import dryrun as PDR  # noqa: E402
from asr_decoder_tpu_torch.parallel import multihost as PMH  # noqa: E402
from asr_decoder_tpu_torch.parallel.decode import (  # noqa: E402
    dp_decode, shard_beam_state, shard_search)
from asr_decoder_tpu_torch.parallel.mesh import (  # noqa: E402
    data_sharding, gather_batch, make_mesh, shard_batch, shard_model,
    sharded_forward)
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.session import \
    OnlineDecoderSession  # noqa: E402

from test_beamsearch import _setup  # noqa: E402
from test_session import make_info, make_wave  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402
from test_torch_serving import graph_infos, port_info  # noqa: E402
from test_torch_train import carry, to_jax_layers  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 (virtual) JAX devices")

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models and several test workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_run(a, b):
    """(state, init log, frame logs) of two decodes, every leaf bit for
    bit."""
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for xl, yl in zip(x, y):
            np.testing.assert_array_equal(_bits(xl), _bits(yl))


def assert_same_paths(got, want):
    """Best paths or n-best lists of two arenas: every field equal, costs
    bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def _paths(res):
    return [(r["words"], r["arc_ids"], r["cost"]) for r in res]


# -- the mesh -----------------------------------------------------------------

def test_mesh_layout_and_contiguous_blocks(monkeypatch):
    """``make_mesh``: the (dp, tp) grid and its shape; ``data_sharding`` /
    ``shard_batch`` give block ``i`` rows ``[i·B/dp, (i+1)·B/dp)``, as
    ``P("dp")`` places them on JAX's mesh; ``gather_batch`` undoes it; the
    default device list is every CUDA card, and there is no CPU
    fallback."""
    mesh = make_mesh(CPU8, tp=2)
    jm = jax_mesh(jax.devices()[:8], tp=2)
    assert mesh.shape == dict(jm.shape) == {"dp": 4, "tp": 2}
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    blocks = shard_batch(mesh, x)
    jx = jax_shard(jm, jnp.asarray(x))
    for i, b in enumerate(blocks):
        dev = jm.devices[i, 0]
        want = [s.data for s in jx.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(b.numpy(), np.asarray(want))
    assert [r for r, _ in data_sharding(mesh, 8)] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    np.testing.assert_array_equal(gather_batch(blocks, "cpu").numpy(), x)
    with pytest.raises(ValueError):
        data_sharding(mesh, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, PMH.local_serving_mesh):
        with pytest.raises(RuntimeError, match="no CUDA"):
            fn()


# -- dp decode ----------------------------------------------------------------

@pytest.mark.parametrize("eps_mode,ndev", [("closure", 8), ("sweeps", 8),
                                           ("closure", 2)])
def test_dp_decode_matches_unsharded_and_jax(eps_mode, ndev):
    """The port's ``dp_decode`` over ``ndev`` CPU blocks: every leaf equal
    to the unsharded port decode; words, arc ids and costs equal to the
    JAX ``dp_decode`` on its 8-device mesh."""
    rng = np.random.default_rng(0)
    fst, dev, i2p, cfg = _setup(rng, eps_mode=eps_mode)
    B, T, V = 8, 15, 9
    loglikes = (rng.standard_normal((B, T, V)) * 3).astype(np.float32)
    port = TorchBeamSearch(to_port(dev), i2p, to_port(cfg), device="cpu")
    mesh = make_mesh(CPU8[:ndev])
    got = dp_decode(mesh, port, loglikes)
    assert_same_run(got, port.decode(loglikes))
    pfst = to_port(fst)
    jsearch = TpuBeamSearch(dev, i2p, cfg)
    jres = jsearch.traceback(*jax_dp_decode(jax_mesh(jax.devices()[:8]),
                                            jsearch, loglikes), fst)
    assert _paths(port.traceback(*got, pfst)) == _paths(jres)
    # a frame mask rides along with the rows
    mask = np.arange(T)[None, :] < rng.integers(5, T + 1, B)[:, None]
    assert_same_run(dp_decode(mesh, port, loglikes, mask),
                    port.decode(loglikes, mask))


def test_shard_search_shares_one_upload_per_device():
    """Replicas on the search's own device are the search itself; a beam
    state splits into contiguous blocks."""
    rng = np.random.default_rng(1)
    _, dev, i2p, cfg = _setup(rng)
    port = TorchBeamSearch(to_port(dev), i2p, to_port(cfg), device="cpu")
    reps = shard_search(make_mesh(CPU8[:4]), port)
    assert all(r is port for r in reps)
    state, _ = port.init_state(8)
    blocks = shard_beam_state(make_mesh(CPU8[:4]), state)
    assert [type(b) for b in blocks] == [type(state)] * 4
    np.testing.assert_array_equal(
        torch.cat([b.tok_cost for b in blocks]).numpy(),
        state.tok_cost.numpy())


def test_dp_decode_biglm_matches_unsharded_and_jax():
    """The BigLM pair search dp-sharded (graph and LM tables replicated,
    beam dp-sharded): every leaf, the per-row overflow flags included,
    equal to the unsharded port; words equal to JAX's mesh decode."""
    jinfo, pinfo = graph_infos("biglm-hclg")
    rng = np.random.default_rng(3)
    B, T = 8, 10
    V = pinfo.search._pdf_max + 1
    lls = (rng.standard_normal((B, T, V)) * 3).astype(np.float32)
    port = pinfo.search
    got = dp_decode(make_mesh(CPU8), port, lls)
    assert_same_run(got, port.decode(lls))
    jres = jinfo.search.traceback(
        *jax_dp_decode(jax_mesh(jax.devices()[:8]), jinfo.search, lls),
        jinfo.fst)
    pres = port.traceback(*got, pinfo.fst)
    assert [r["words"] for r in pres] == [r["words"] for r in jres]
    for p, j in zip(pres, jres):
        assert p["cost"] == pytest.approx(j["cost"], abs=1e-5)


# -- the dp-sharded arena -----------------------------------------------------

def _arena_paths(info, mesh, waves, arena_cls=BatchedStreamingDecoder):
    arena = arena_cls(info, len(waves), mesh=mesh)
    cids = [arena.acquire() for _ in waves]
    for cid, w in zip(cids, waves):
        for lo in range(0, len(w), 4000):
            arena.push(cid, w[lo:lo + 4000], eos=lo + 4000 >= len(w))
    arena.drain()
    return [arena.get_best_path(c) for c in cids]


@pytest.mark.parametrize("ndev", [8, 2])
def test_dp_arena_matches_unsharded_and_jax(ndev):
    """``BatchedStreamingDecoder(mesh=...)`` decodes every channel as the
    unsharded arena (words, arc ids and costs bit for bit) and as JAX's
    mesh arena (words; costs within 1e-3)."""
    waves = [make_wave(200 + s, n=8000) for s in range(8)]
    jinfo = make_info(seed=3)
    pinfo = port_info(jinfo)
    want = _arena_paths(pinfo, None, waves)
    got = _arena_paths(pinfo, make_mesh(CPU8[:ndev]), waves)
    assert_same_paths(got, want)
    jres = _arena_paths(jinfo, jax_mesh(jax.devices()[:8]), waves, JaxArena)
    assert [g["words"] for g in got] == [j["words"] for j in jres]
    for g, j in zip(got, jres):
        assert g["cost"] == pytest.approx(j["cost"], abs=1e-3)
    with pytest.raises(ValueError):
        BatchedStreamingDecoder(pinfo, 6, mesh=make_mesh(CPU8[:4]))


def test_dp_arena_slots_and_nbest():
    """Acquire/release across blocks, a channel of the second block
    restarted mid-stream, its n-best from the snapshot: equal to the
    unsharded arena."""
    pinfo = port_info(make_info(seed=4))
    waves = [make_wave(300 + s, n=4000) for s in range(4)]

    def run(mesh):
        eng = BatchedStreamingDecoder(pinfo, 4, mesh=mesh)
        cids = [eng.acquire() for _ in waves]
        eng.release(cids[0])
        cids[0] = eng.acquire()
        for cid, w in zip(cids, waves):
            eng.push(cid, w[:2400])
        eng.drain()
        eng.init_decoding(cids[3])
        for cid, w in zip(cids, waves):
            eng.push(cid, w[2400:], eos=True)
        eng.drain()
        return [eng.get_best_path(c) for c in cids], eng.get_nbest(cids[3], 3)
    (paths, nbest), (want, want_nbest) = run(make_mesh(CPU8[:2])), run(None)
    assert_same_paths(paths, want)
    assert_same_paths(nbest, want_nbest)


def test_dp_arena_round_calls_equal_the_kept_calls():
    """A server round's calls on a dp arena of two blocks — one fbank for
    every push (``fbank_many``, then ``push(..., fbank=)``) and one beam
    copy a block (``copy_beams``, then ``snapshot(cid, beam)``), channels
    in no order of blocks — give each channel the snapshot the kept
    per-channel ``push`` and ``snapshot`` give: the same frames, tokens
    and words, and costs within fp32 rounding (the stacked fbank's mel
    product may sum a frame in another order than a lone stream's)."""
    pinfo = port_info(make_info(seed=6))
    waves = [make_wave(400 + s, n=5600) for s in range(4)]
    order = [3, 0, 2, 1]

    def run(batched):
        eng = BatchedStreamingDecoder(pinfo, 4, mesh=make_mesh(CPU8[:2]))
        cids = [eng.acquire() for _ in waves]
        snaps = []
        for lo in range(0, 5600, 1600):
            pushes = [(cids[i], waves[i][lo:lo + 1600], lo + 1600 >= 5600)
                      for i in order]
            fbanks = (eng.fbank_many(pushes) if batched
                      else [None] * len(pushes))
            for (cid, pcm, eos), fbank in zip(pushes, fbanks):
                eng.push(cid, pcm, eos, fbank=fbank)
            while eng.pending_work():
                eng.step()
            beams = (eng.copy_beams([cid for cid, _, _ in pushes])
                     if batched else [None] * len(pushes))
            snaps.append([eng.snapshot(cid, beam) for (cid, _, _), beam
                          in zip(pushes, beams)])
        return eng, snaps
    (eng, got), (_, want) = run(True), run(False)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g.frames_decoded == w.frames_decoded
            for a, b in zip(g.beam, w.beam):
                assert a.shape == b.shape and a.dtype == b.dtype
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(a, b)
            assert (eng.get_best_path_from(g)["words"]
                    == eng.get_best_path_from(w)["words"])
    assert got[-1][0].frames_decoded > 0


# -- the tp-sharded AM --------------------------------------------------------

def test_tp_am_matches_jax_and_decodes_the_same():
    """The AM with affine rows split over tp (dp 4 × tp 2): within 1e-5 of
    JAX's tp-sharded AM and of the unsharded port AM; the decode over its
    posteriors gives the unsharded decode's words."""
    jinfo = make_info(seed=5)
    pinfo = port_info(jinfo)
    rng = np.random.default_rng(2)
    B, T = 8, 24
    D = jinfo.am_layers[0].input_dim
    feats = (rng.standard_normal((B, T, D)) * 2).astype(np.float32)
    jm = jax_mesh(jax.devices()[:8], tp=2)
    jstate = [init_layer_state(l, B) for l in jinfo.am_layers]
    with jm:
        jll, _ = jax_am_forward(jax_shard_model(jm, jinfo.am_layers),
                                jax_shard(jm, jnp.asarray(feats)), [
            jax.tree.map(lambda a: jax.device_put(
                a, jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(
                    "dp", *([None] * (a.ndim - 1))))), s) for s in jstate])
    model = shard_model(make_mesh(CPU8, tp=2), pinfo.am_layers)
    assert model.mesh.shape == {"dp": 4, "tp": 2}
    with torch.inference_mode():
        blocks, _ = sharded_forward(model, torch.from_numpy(feats))
        ll = gather_batch(blocks, "cpu")
        ll0, _ = am_forward(pinfo.am_layers, torch.from_numpy(feats),
                            [l.init_state(B, pinfo.device)
                             for l in pinfo.am_layers])
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ll.numpy(), ll0.numpy(), rtol=1e-5, atol=1e-5)
    for name, w in model.unsharded().items():
        np.testing.assert_array_equal(
            w.detach().numpy(),
            dict(pinfo.nnet.layers[1:].named_parameters())[
                name.partition(".")[2]].detach().numpy())
    search = pinfo.search
    got = search.traceback(*search.decode(ll), pinfo.fst)
    want = search.traceback(*search.decode(ll0), pinfo.fst)
    assert [r["words"] for r in got] == [r["words"] for r in want]
    for g, w in zip(got, want):
        assert g["cost"] == pytest.approx(w["cost"], abs=1e-4)


# -- multi-host ---------------------------------------------------------------

def test_multihost_skeleton_per_host_arenas():
    """Per-host arenas over disjoint device groups decode as per-stream
    sessions do, and one 'host' dropped does not disturb another's
    channels; the context, the local and global mesh shapes, and the host
    partition."""
    ctx = PMH.init_multihost()
    assert isinstance(ctx, PMH.MultihostContext) and ctx.is_primary
    assert PMH.local_serving_mesh(devices=CPU8).shape == {"dp": 8, "tp": 1}
    assert PMH.global_mesh(ctx, tp=2, devices=CPU8).shape == \
        {"dp": 4, "tp": 2}
    groups = PMH.partition_hosts(list(range(8)), 2)
    assert groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(RuntimeError, match="not initialized"):
        PMH.global_mesh(PMH.MultihostContext(2, 0, None), devices=CPU8)
    with pytest.raises(ValueError, match="coordinator"):
        PMH.init_multihost(num_processes=2)

    jinfo = make_info(seed=9)
    waves = make_wave(31, n=9000), make_wave(32, n=9000)
    want = []
    for w in waves:
        s = OnlineDecoderSession(port_info(jinfo))
        s.process_data(w, eos=True)
        want.append(s.get_best_path())
    arenas = PMH.simulated_host_arenas(lambda: port_info(jinfo), 2,
                                       num_channels=4, devices=CPU8)
    assert [a.mesh.shape for a in arenas] == [{"dp": 4, "tp": 1}] * 2
    cids = [a.acquire() for a in arenas]
    for arena, cid, w in zip(arenas, cids, waves):
        arena.push(cid, w, eos=True)
    arenas[0] = None                       # "host 0 dies"
    arenas[1].drain()
    got = arenas[1].get_best_path(cids[1])
    assert got["words"] == want[1]["words"]
    assert got["cost"] == want[1]["cost"]


def test_distributed_selftest_four_gloo_ranks():
    """Four real processes over gloo (2 'hosts' × 2 ranks, dp 2 × tp 2):
    each checks its dp block of the tp-sharded AM, whose row blocks are
    joined with ``all_gather``, and the job's ``all_reduce`` of the finite
    count; every worker prints ``MH_OK``."""
    oks = PMH.run_distributed_selftest(4, timeout=90, backend="gloo")
    assert len(oks) == 4
    assert all("mesh=dp2xtp2" in ln for ln in oks)
    assert sorted(ln.split("block=")[1] for ln in oks) == \
        ["0.0", "0.1", "1.0", "1.1"]


def test_worker_runs_without_jax():
    """``python -m asr_decoder_tpu_torch.parallel._mh_worker`` (one gloo
    rank) runs to ``MH_OK`` with nothing of jax or of the JAX package in
    ``sys.modules``."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['_mh_worker', '127.0.0.1:{PMH._free_port()}', '1', "
        "'0', 'gloo', '60']\n"
        "runpy.run_module('asr_decoder_tpu_torch.parallel._mh_worker', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'asr_decoder_tpu'))\n"
        "print('modules', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MH_OK process=0/1" in proc.stdout


# -- the dry run --------------------------------------------------------------

def test_dryrun_entry_and_multichip():
    """``entry()`` on the CPU, then ``dryrun_multichip(4)`` over
    ``["cpu"] * 4`` (dp 2 × tp 2): the sharded CTC step equals the
    unsharded one, the dp decode and the per-host meshes equal the
    single-device decode, the tp AM is within ``TP_AM_TOL``."""
    fn, args = PDR.entry("cpu")
    y = fn(*args)
    assert tuple(y.shape) == (2, 33, 512) and bool(torch.isfinite(y).all())
    out = PDR.dryrun_multichip(4, ["cpu"] * 4)
    assert out["mesh"] == {"dp": 2, "tp": 2} and out["hosts"] == 2
    assert out["train"]["param_err"] <= PDR.TRAIN_TOL
    assert out["tp_am_err"] < PDR.TP_AM_TOL


def test_dryrun_train_step_matches_jax():
    """The dry run's dp 2 × tp 2 CTC step against JAX's ``ctc_train_step``
    on the same weights and batch: the loss within 1e-4 relative, every
    updated parameter within 1e-3 by name."""
    from asr_decoder_tpu_torch.models.flagship import init_opt_state
    nnet, x, labels, pads, _ = PDR.train_inputs(2, "cpu")
    jlayers = to_jax_layers(to_numpy_layers(nnet))
    B = len(x)
    jlayers, _, jloss = jax_ctc_train_step(
        jlayers, jax_opt(jlayers), jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(pads), [init_layer_state(l, B) for l in jlayers])
    model = shard_model(make_mesh(["cpu"] * 4, tp=2), nnet.layers)
    loss = PDR.sharded_ctc_train_step(model, init_opt_state(model), x,
                                      labels, pads)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    got = model.unsharded()
    for i, (_, _, _, _, params) in enumerate(carry(jlayers)):
        for k, v in params.items():
            np.testing.assert_allclose(got[f"layers.{i}.{k}"].detach()
                                       .numpy(), v, atol=1e-3)
