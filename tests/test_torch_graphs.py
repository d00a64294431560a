"""The port's captured-graph execution (``asr_decoder_tpu_torch/utils/
cuda_graphs.py``) through its CPU path: the frame loop every search shares
(``ops/beamsearch.py:run_frames``) and the AM chunk (``models/nnet.py:
GraphedAm``, as ``OnlineDecoderInfo.score`` and ``tools/bench.py`` call
it), against the JAX package on the same numpy inputs.

On the CPU a ``GraphRunner`` calls its body on the same static buffers that
the card captures and replays, so these tests hold the buffer handling: the
frame window, the dead-frame skip, masked rows, and that nothing a caller
keeps shares memory with the buffers.

Tolerance: none for the searches (every op is an exact int32 op, an fp32
add or compare, a gather or a sort: the JAX logs bit for bit, as in
``tests/test_torch_beamsearch.py``).  The AM against JAX at atol 1e-4 in
the log domain, as in ``tests/test_torch_models.py`` (XLA's and PyTorch's
matrix products sum in other orders); against the port's own
``am_forward`` bit for bit.
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu.fst.device_fst import DeviceFst  # noqa: E402
from asr_decoder_tpu.lm import device_lm as JL  # noqa: E402
from asr_decoder_tpu.lm.arpa import parse_arpa  # noqa: E402
from asr_decoder_tpu.models import nnet as JN  # noqa: E402
from asr_decoder_tpu.models.flagship import make_flagship  # noqa: E402
from asr_decoder_tpu.ops import beamsearch as J  # noqa: E402
from asr_decoder_tpu.ops import beamsearch_biglm as JB  # noqa: E402
from asr_decoder_tpu.ops import beamsearch_clg as JC  # noqa: E402
from asr_decoder_tpu_torch.fst.device_fst import \
    DeviceFst as PortDeviceFst  # noqa: E402
from asr_decoder_tpu_torch.lm import device_lm as PL  # noqa: E402
from asr_decoder_tpu_torch.models import nnet as PN  # noqa: E402
from asr_decoder_tpu_torch.models.flagship import \
    ctc_train_step  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch as P  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch_biglm as PB  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch_clg as PC  # noqa: E402
from asr_decoder_tpu_torch.ops import fetch, gather  # noqa: E402
from asr_decoder_tpu_torch.utils.cuda_graphs import (  # noqa: E402
    GraphRunner, LaunchCounts)

from test_beamsearch import random_decode_graph  # noqa: E402
from test_biglm import _setup_biglm  # noqa: E402
from test_clg import make_clg  # noqa: E402
from test_lm import ARPA, ARPA2  # noqa: E402
from test_session import make_info  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402
from test_torch_serving import port_info  # noqa: E402

KINDS = ["v3", "v2-closure", "v2-sweeps", "clg", "biglm-hclg"]
B, T = 3, 12
CUT = 5                          # the first chunk's frames
DEAD = 3                         # a frame masked in every row
SHORT_ROW, SHORT_LEN = 1, 8      # a row masked from frame 8 on


def _search_cfg(**kw):
    return DecoderConfig(**{**dict(beam=1e9, beam_width=64, arc_lanes=8,
                                   max_active=64, min_active=0,
                                   lattice_beam=1e9), **kw})


def _engines(kind: str):
    """(JAX search, port search on the CPU, V) on one small seeded graph."""
    if kind == "clg":
        _, g = make_clg(3)
        i2p = np.arange(7, dtype=np.int32)
        cfg = _search_cfg(eps_mode="sweeps")
        return (JC.TpuClgBeamSearch(g, i2p, cfg),
                PC.TorchClgBeamSearch(to_port(g), i2p, to_port(cfg),
                                      device="cpu"), 7)
    if kind == "biglm-hclg":
        fsa1 = parse_arpa(ARPA)
        fsas = (fsa1, parse_arpa(ARPA2, word2id=fsa1.vocab))
        _, _, dev, i2p, cfg = _setup_biglm(2, lm_lanes=16)
        return (JB.TpuBigLmBeamSearch(dev, i2p, JL.DeviceDiffLm.build(*fsas),
                                      cfg),
                PB.TorchBigLmBeamSearch(
                    to_port(dev), i2p,
                    PL.DeviceDiffLm.build(*to_port(fsas), device="cpu"),
                    to_port(cfg), device="cpu"), 7)
    fst = random_decode_graph(np.random.default_rng(11))
    i2p = np.arange(9, dtype=np.int32)
    mode = "closure" if kind != "v2-sweeps" else "sweeps"
    cfg = _search_cfg(eps_mode=mode,
                      relax_impl="topk" if kind == "v3" else "sort")
    js = J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=8), i2p, cfg)
    ps = P.TorchBeamSearch(PortDeviceFst.build(to_port(fst), arc_lanes=8),
                           i2p, to_port(cfg), device="cpu")
    assert (ps.mode, ps.relax_impl) == (js.mode, js.relax_impl)
    return js, ps, 9


def _inputs(V: int):
    rng = np.random.default_rng(4)
    ll = (rng.standard_normal((B, T, V)) * 3).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[:, DEAD] = False
    mask[SHORT_ROW, SHORT_LEN:] = False
    return ll, mask


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(jax_tree, port_tree):
    for j, p in zip(jax_tree, port_tree):
        if isinstance(p, torch.Tensor):
            assert np.asarray(j).shape == tuple(p.shape)
            np.testing.assert_array_equal(_bits(j), _bits(p.numpy()))
        else:
            _assert_same(j, p)


def _cat(logs):
    """Chunk logs (each leaf frame-major) joined along the frame axis."""
    return type(logs[0])(*(torch.cat(leaves) for leaves in zip(*logs)))


@pytest.mark.parametrize("window", [P.FRAME_WINDOW, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_two_chunks_equal_one_chunk_and_jax(kind, window, monkeypatch):
    """``advance`` over two chunks through the frame runner equals one
    ``advance`` over the whole input and the JAX search's, leaf for leaf,
    with a dead frame and a partly masked row; a window of 2 frames makes
    each chunk span several windows of the runner's buffers."""
    monkeypatch.setattr(P, "FRAME_WINDOW", window)
    js, ps, V = _engines(kind)
    ll, mask = _inputs(V)
    jstate, jinit, jlogs = js.decode(ll, mask)
    state, init = ps.init_state(B)
    _assert_same(jinit, init)
    one_state, one_logs = ps.advance(state, ll, mask)
    s1, l1 = ps.advance(state, ll[:, :CUT], mask[:, :CUT])
    s2, l2 = ps.advance(s1, ll[:, CUT:], mask[:, CUT:])
    _assert_same(jstate, s2)
    _assert_same(jstate, one_state)
    _assert_same(jlogs, one_logs)
    _assert_same(jlogs, _cat([l1, l2]))
    assert len(ps._graphs) == 1          # one runner for every chunk


@pytest.mark.parametrize("kind", KINDS)
def test_returned_state_and_logs_outlive_the_next_advance(kind):
    """A beam state and frame log that ``advance`` returned are unchanged
    by the next ``advance`` (they share no memory with the runner's
    static buffers)."""
    _, ps, V = _engines(kind)
    ll, mask = _inputs(V)
    state, _ = ps.init_state(B)
    s1, l1 = ps.advance(state, ll[:, :CUT], mask[:, :CUT])
    kept = [t.clone() for t in (*s1, *l1)]
    ps.advance(s1, ll[:, CUT:], mask[:, CUT:])
    ps.advance(state, ll[:, CUT:], mask[:, CUT:])
    for was, now in zip(kept, (*s1, *l1)):
        assert torch.equal(was, now)


def _small_am(seed=0):
    jnet = make_flagship(jax.random.PRNGKey(seed), feat_dim=16, num_pdfs=16,
                         hidden=16, proj=8, num_layers=2, context=1)
    layers = [(l.kind, l.input_dim, l.output_dim, l.meta,
               {k: np.asarray(v) for k, v in l.params.items()})
              for l in jnet.layers]
    return jnet, PN.from_numpy_layers(layers, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"skip": 2}, {"skip": 2,
                                                  "skip_copy": True}])
def test_graphed_am_two_chunks_match_am_forward_and_jax(kw):
    """``GraphedAm`` over two chunks (the carries through its buffers, the
    splice layer included) equals the port's ``am_forward`` bit for bit
    and the JAX ``am_forward`` within 1e-4."""
    jnet, pnet = _small_am()
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(
        np.float32)
    am = PN.GraphedAm(pnet.layers)
    jst, pst, est = jnet.init_state(2), pnet.init_state(2), \
        pnet.init_state(2)
    with torch.inference_mode():
        for lo, hi in ((0, 6), (6, 12)):
            jy, jst = JN.am_forward(jnet.layers, jnp.asarray(x[:, lo:hi]),
                                    jst, **kw)
            py, pst = am(torch.from_numpy(x[:, lo:hi]), pst, **kw)
            ey, est = PN.am_forward(pnet.layers, torch.from_numpy(
                x[:, lo:hi]), est, **kw)
            assert torch.equal(py, ey)
            np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-4)
            for js, ps, es in zip(jst, pst, est):
                for k in js:
                    assert torch.equal(ps[k], es[k])
                    np.testing.assert_allclose(ps[k].numpy(),
                                               np.asarray(js[k]), rtol=0,
                                               atol=1e-4)
    assert len(am._runners) == 1


def test_score_state_outlives_the_next_chunk():
    """``OnlineDecoderInfo.score``'s loglikes and AM state are unchanged by
    the next chunk through the same graphed AM, and equal the eager
    ``am_forward`` of the same chunk."""
    info = port_info(make_info())
    C = info.config.chunk_frames
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, C, info.am_layers[0].input_dim)).astype(np.float32))
    valid = np.array([C, C - 4])
    with torch.inference_mode():
        st0 = [l.init_state(2, info.device) for l in info.am_layers]
        y1, st1, mask = info.score(x, st0, valid)
        kept = (y1.clone(), [{k: v.clone() for k, v in s.items()}
                             for s in st1])
        info.score(x.flip(1), st1, valid)
        ey, est = PN.am_forward(info.am_layers, x, [
            l.init_state(2, info.device) for l in info.am_layers])
    assert mask[1].sum() == C - 4
    assert torch.equal(y1, kept[0]) and torch.equal(y1, ey)
    for now, was, eager in zip(st1, kept[1], est):
        for k in was:
            assert torch.equal(now[k], was[k])
            assert torch.equal(now[k], eager[k])
    assert len(info._am_graphs) == 1


def test_runner_refuses_grad_mode_and_training_stays_eager():
    """A runner (and so ``GraphedAm``) refuses to run with autograd on;
    ``ctc_train_step``, which needs autograd, trains through a training
    runner, which turns it on (on the CPU its body runs eagerly)."""
    buf = torch.zeros(3)
    run = GraphRunner(lambda b: b.add_(1), buf, "cpu")
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="no backward"):
            run()
        _, pnet = _small_am()
        with pytest.raises(RuntimeError, match="no backward"):
            PN.GraphedAm(pnet.layers)(torch.zeros(2, 4, 16),
                                      pnet.init_state(2))
    with torch.no_grad():
        run()
    with torch.inference_mode():
        run()
    assert buf.tolist() == [2.0] * 3
    opt = torch.optim.Adam(pnet.parameters(), lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 10, 16)).astype(np.float32))
    labels = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    pads = torch.tensor([[0.0, 0, 0], [0, 0, 1]])
    losses = [float(ctc_train_step(pnet, opt, x, labels, pads,
                                   pnet.init_state(2))) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_launch_counts_add_the_capture_once_a_replay():
    """The counters a capture moved are taken back when it ends and added
    again, with the recorded shapes, at every replay — and shapes only
    while someone records them."""
    stub = types.SimpleNamespace(launches=5, shapes=None)

    def body():
        stub.launches += 3
        if stub.shapes is not None:
            stub.shapes.add(("B", "V"))

    counts = LaunchCounts([stub])
    with counts.capture():
        body()
    assert (stub.launches, stub.shapes) == (5, None)
    assert counts.launches == [3] and counts.shapes == [{("B", "V")}]
    for _ in range(4):
        counts.replay()
    assert stub.launches == 5 + 4 * 3 and stub.shapes is None
    stub.shapes = set()
    counts.replay()
    assert stub.launches == 5 + 5 * 3 and stub.shapes == {("B", "V")}


def test_cpu_runner_calls_its_body_and_counts_nothing():
    """On the CPU a runner runs its body on its buffers at every call and
    never captures; a CPU search launches no kernel, so the counters stay."""
    calls = []
    bufs = (torch.zeros(2), torch.ones(2))
    run = GraphRunner(lambda b: calls.append(b) or b[0] + b[1], bufs, "cpu")
    with torch.inference_mode():
        outs = [run() for _ in range(3)]
    assert len(calls) == 3 and all(c is bufs for c in calls)
    assert run.graph is None and all(o.tolist() == [1.0, 1.0] for o in outs)
    before = (gather.launches, fetch.launches)
    _, ps, V = _engines("v3")
    ll, mask = _inputs(V)
    ps.decode(ll, mask)
    assert (gather.launches, fetch.launches) == before


@pytest.mark.parametrize("kind", ["v3", "v2-sweeps", "clg", "biglm-hclg",
                                  "am"])
def test_a_dropped_search_or_am_frees_its_runners(kind):
    """No reference cycle runs through a cached runner: with the cyclic
    collector off, dropping a search (or an AM) that has run frees it and
    its runners, whose graphs and memory pools go with them on the card."""
    import gc
    import weakref
    if kind == "am":
        _, pnet = _small_am()
        owner = PN.GraphedAm(pnet.layers)
        with torch.inference_mode():
            owner(torch.zeros(2, 4, 16), pnet.init_state(2))
        runners = list(owner._runners.values())
    else:
        _, owner, V = _engines(kind)
        ll, mask = _inputs(V)
        owner.decode(ll, mask)
        runners = list(owner._graphs.values())
    assert len(runners) == 1
    refs = [weakref.ref(owner), weakref.ref(runners[0])]
    del runners
    gc.disable()
    try:
        del owner
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
