"""The port's CTC loss (``asr_decoder_tpu_torch/models/flagship.py:ctc_loss``,
``optax.ctc_loss`` op for op) and its training step through
``utils/cuda_graphs.py:TrainingGraphRunner``, against the JAX package on the
same numpy inputs; then, on a GPU, the captured step against the eager one.

A row whose labels cannot fit its frames (label count plus repeats > T) is
the case the port used to get wrong: ``F.ctc_loss`` gave inf, and one such
row wrote NaN into every parameter at the next Adam step, where optax floors
its α at -1e5 and keeps training.

Tolerances: each sequence's loss within 1e-5 relative (the same ops in the
same order; ``exp``/``log1p`` round otherwise in the last bit); gradients
within 1e-3 relative + 1e-5 absolute, as ``tests/test_torch_train.py``; the
parameters after five Adam steps within 1e-3 absolute (one update's size at
lr = 1e-3, as there).  On the GPU the captured step equals the eager step
bit for bit: the same kernels on the same inputs.
"""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.models import flagship as PFL
from asr_decoder_tpu_torch.models import nnet as PN
from asr_decoder_tpu_torch.utils import cuda_graphs as CG

B, T, FEAT, PDFS = 4, 12, 10, 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models and several test workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX side, imported here so that the GPU tests below run where
    there is no jax."""
    jax = pytest.importorskip("jax")
    import optax
    from asr_decoder_tpu.models import flagship
    from test_torch_train import carry, to_jax_layers
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, optax=optax,
                                 FL=flagship, carry=carry,
                                 to_jax_layers=to_jax_layers)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# label rows (0 = padding) for T = 8 frames of the raw-loss cases
LOSS_CASES = {
    "repeats": [[1, 1, 2, 0, 0, 0], [3, 3, 3, 0, 0, 0], [4, 5, 4, 5, 0, 0]],
    "padded": [[2, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0], [6, 1, 2, 3, 0, 0]],
    "boundary": [[1, 1, 1, 1, 0, 0], [1, 2, 3, 4, 5, 6], [2, 2, 3, 3, 0, 0]],
    "infeasible": [[1, 1, 1, 1, 1, 0], [1, 2, 3, 4, 5, 6], [3, 3, 2, 2, 1, 1]],
}                       # labels + repeats: 9 > 8, 6, 9 > 8


def _label_batch(rows):
    labels = np.array(rows, np.int32)
    return labels, (labels == 0).astype(np.float32)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ctc_loss_matches_optax(J, case):
    """Each row's loss and the gradient of the batch mean by the logits:
    repeated labels, padded and empty rows, rows that just fit (labels plus
    repeats == T) and rows that cannot."""
    labels, pads = _label_batch(LOSS_CASES[case])
    logits = np.random.default_rng(len(case)).standard_normal(
        (len(labels), 8, PDFS)).astype(np.float32) * 2

    def mean_loss(lg):
        return J.optax.ctc_loss(lg, J.jnp.zeros(lg.shape[:2]),
                                J.jnp.asarray(labels),
                                J.jnp.asarray(pads)).mean()
    want = J.optax.ctc_loss(J.jnp.asarray(logits),
                            J.jnp.zeros(logits.shape[:2]),
                            J.jnp.asarray(labels), J.jnp.asarray(pads))
    want_grad = J.jax.grad(mean_loss)(J.jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = PFL.ctc_loss(lg, torch.from_numpy(labels), torch.from_numpy(pads))
    got.mean().backward()
    assert torch.isfinite(got).all() and torch.isfinite(lg.grad).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-5)
    if case == "infeasible":             # rows 0 and 2: the floor, not inf
        assert (got.detach()[[0, 2]] > 5e4).all() and got[1] < 1e3


def _model_batch(kind: str):
    """B rows of T frames: repeated labels and a padded row; with
    ``infeasible`` the last row holds 10 labels with 3 repeats, 13 > T."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, FEAT)).astype(np.float32)
    rows = [[1, 1, 2, 3, 0, 0, 0, 0, 0, 0], [4, 0, 0, 0, 0, 0, 0, 0, 0, 0],
            [5, 6, 6, 5, 2, 0, 0, 0, 0, 0], [2, 3, 4, 0, 0, 0, 0, 0, 0, 0]]
    if kind == "infeasible":
        rows[-1] = [1, 1, 2, 2, 3, 3, 4, 5, 6, 1]
    labels, pads = _label_batch(rows)
    return x, labels, pads


def _jax_model(J):
    return J.FL.make_flagship(J.jax.random.PRNGKey(0), feat_dim=FEAT,
                              num_pdfs=PDFS, hidden=16, proj=8, num_layers=2,
                              context=1)


def _tensors(batch):
    return [torch.from_numpy(a) for a in batch]


@pytest.mark.parametrize("kind", ["feasible", "infeasible"])
def test_ctc_loss_fn_and_gradients_match_jax(J, kind):
    """The loss through the model and every parameter's gradient, by name,
    against ``jax.value_and_grad`` of the JAX ``ctc_loss_fn``."""
    jnet = _jax_model(J)
    x, labels, pads = _model_batch(kind)
    jloss, jgrads = J.jax.value_and_grad(J.FL.ctc_loss_fn)(
        jnet.layers, J.jnp.asarray(x), J.jnp.asarray(labels),
        J.jnp.asarray(pads), jnet.init_state(B))
    pnet = PN.from_numpy_layers(J.carry(jnet.layers), device="cpu")
    pnet.requires_grad_(True)
    loss = PFL.ctc_loss_fn(pnet.layers, *_tensors((x, labels, pads)),
                           pnet.init_state(B))
    loss.backward()
    assert np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    seen = 0
    for i, (jl, pl) in enumerate(zip(jgrads, pnet.layers)):
        for name, jg in jl.params.items():
            pg = getattr(pl, name).grad
            if pl.kind == "prior":
                assert pg is None
                continue
            np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{i}.{name}")
            seen += 1
    assert seen == 2 + 7 * 2 + 2


@pytest.mark.parametrize("kind", ["feasible", "infeasible"])
def test_five_steps_through_the_runner_match_jax(J, kind):
    """Five ``ctc_train_step`` calls (the training runner's CPU path: the
    inputs copied into its static buffers, its body run on them) against
    the JAX jitted step: finite losses within 1e-3 relative, every
    parameter within 1e-3; one runner for the five steps, its buffers
    holding the last batch."""
    jnet = _jax_model(J)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(5):
        x, labels, pads = _model_batch(kind)
        batches.append((x + rng.standard_normal(x.shape).astype(np.float32)
                        * 0.1, labels, pads))
    pnet = PN.from_numpy_layers(J.carry(jnet.layers), device="cpu")
    opt = PFL.init_opt_state(pnet, 1e-3)
    layers = J.to_jax_layers(J.carry(jnet.layers))
    opt_state = J.FL.init_opt_state(layers, 1e-3)
    jlosses, plosses = [], []
    for x, labels, pads in batches:
        layers, opt_state, jloss = J.FL.ctc_train_step(
            layers, opt_state, J.jnp.asarray(x), J.jnp.asarray(labels),
            J.jnp.asarray(pads), jnet.init_state(B), 1e-3)
        jlosses.append(float(jloss))
        plosses.append(float(PFL.ctc_train_step(
            pnet, opt, *_tensors((x, labels, pads)), pnet.init_state(B))))
    assert np.all(np.isfinite(plosses))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    for (kind_, _, _, _, pp), jl in zip(PN.to_numpy_layers(pnet), layers):
        for name, v in pp.items():
            assert np.isfinite(v).all()
            np.testing.assert_allclose(v, np.asarray(jl.params[name]),
                                       rtol=0, atol=1e-3,
                                       err_msg=f"{kind_}.{name}")
    (run,) = PFL._TRAIN_GRAPHS[opt].values()
    assert isinstance(run, CG.TrainingGraphRunner) and run.graph is None
    x, labels, pads = batches[-1]
    assert np.array_equal(run.buffers[0].numpy(), x)
    assert np.array_equal(run.buffers[1].numpy(), labels)


def _small_net(device="cpu"):
    return PFL.make_flagship(0, feat_dim=FEAT, num_pdfs=PDFS, hidden=16,
                             proj=8, num_layers=2, device=device)


def test_inference_runner_refuses_grad_where_training_runs():
    """After training steps through the training runner (with autograd
    on), the inference runner of the same model still refuses grad mode
    and runs without it."""
    net = _small_net()
    opt = PFL.init_opt_state(net)
    batch = _tensors(_model_batch("feasible"))
    with torch.no_grad():       # the training runner turns autograd on
        loss = PFL.ctc_train_step(net, opt, *batch, net.init_state(B))
    assert torch.isfinite(loss) and not loss.requires_grad
    assert all(p.grad is not None for p in net.parameters()
               if p is not net.layers[-1].log_priors)
    am = PN.GraphedAm(net.layers)
    with pytest.raises(RuntimeError, match="no backward"):
        am(batch[0], net.init_state(B))
    net.requires_grad_(False)
    with torch.inference_mode():
        y, _ = am(batch[0], net.init_state(B))
    assert y.shape == (B, T, PDFS) and torch.isfinite(y).all()


def test_dropped_model_and_optimizer_are_freed():
    """The runner cache holds neither: with the cyclic collector off, a
    model and optimizer that have stepped are freed with their runner when
    the caller drops them."""
    net = _small_net()
    opt = PFL.init_opt_state(net)
    PFL.ctc_train_step(net, opt, *_tensors(_model_batch("feasible")),
                       net.init_state(B))
    (run,) = PFL._TRAIN_GRAPHS[opt].values()
    refs = [weakref.ref(o) for o in (net, opt, run)]
    n = len(PFL._TRAIN_GRAPHS)
    del run
    gc.disable()
    try:
        del net, opt
        assert [r() for r in refs] == [None, None, None]
        assert len(PFL._TRAIN_GRAPHS) == n - 1
    finally:
        gc.enable()


def test_loss_reads_nothing_from_the_host():
    """The loss through the model on the meta device, where every host
    read raises: the step has no synchronising copy for a capture to
    refuse (``F.ctc_loss`` copies its lengths to the host)."""
    net = _small_net().to("meta")
    x, labels, pads = (t.to("meta") for t in _tensors(
        _model_batch("infeasible")))
    loss = PFL.ctc_loss_fn(net.layers, x, labels, pads,
                           net.init_state(B, "meta"))
    assert loss.shape == () and loss.device.type == "meta"


def test_capturable_only_for_cuda_parameters():
    opt = PFL.init_opt_state(_small_net())
    assert [g["capturable"] for g in opt.param_groups] == [False]


def test_copy_into_makes_one_call_a_dtype(monkeypatch):
    calls = []
    real = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda d, s: calls.append(len(d)) or real(d, s))
    dst = [torch.zeros(3), torch.zeros(2, dtype=torch.int32), torch.zeros(4)]
    src = [torch.ones(3), torch.full((2,), 7, dtype=torch.int32),
           torch.arange(4.0)]
    CG.copy_into(dst, src)
    assert sorted(calls) == [1, 2]
    assert all(torch.equal(d, s) for d, s in zip(dst, src))


def test_static_buffers_and_key_follow_the_nest():
    """The runners' keys and buffers: one structure, shapes and dtypes."""
    inputs = (torch.ones(2, 3), [{"c": torch.zeros(4, dtype=torch.int32)}])
    bufs = CG.static_buffers(inputs, "cpu")
    assert type(bufs) is tuple and type(bufs[1]) is list
    assert CG.static_key(bufs) == CG.static_key(inputs)
    assert CG.static_key(inputs) != CG.static_key(
        (torch.ones(2, 3), [{"c": torch.zeros(4)}]))
    CG.copy_into(bufs, inputs)
    assert torch.equal(bufs[0], inputs[0])
    assert torch.equal(bufs[1][0]["c"], inputs[1][0]["c"])


@pytest.mark.cuda
def test_capturable_on_cuda(cuda):
    opt = PFL.init_opt_state(_small_net(cuda))
    assert [g["capturable"] for g in opt.param_groups] == [True]


@pytest.mark.cuda
def test_graph_steps_equal_eager_steps(cuda):
    """Two models from one seed stepped on the same batches, one through
    the captured graph, one eagerly (the runner's body called directly):
    losses, parameters and gradients bit for bit after every step (after
    the first, which runs eagerly and then captures, the gradients are
    the first step's, copied into the graph's own buffers); the search
    kernels' counters do not move."""
    from asr_decoder_tpu_torch.ops import fetch, gather
    nets = [_small_net(cuda) for _ in range(2)]
    opts = [PFL.init_opt_state(n) for n in nets]
    rng = np.random.default_rng(5)
    before = (gather.launches, fetch.launches)
    for i in range(4):
        x, labels, pads = _model_batch("infeasible" if i == 2 else "feasible")
        x = x + rng.standard_normal(x.shape).astype(np.float32)
        batch = [t.to(cuda) for t in _tensors((x, labels, pads))]
        losses = []
        for eager, net, opt in zip((False, True), nets, opts):
            call = CG.GraphRunner._run
            if eager:
                CG.GraphRunner._run = CG.GraphRunner._eager
            try:
                losses.append(PFL.ctc_train_step(net, opt, *batch,
                                                 net.init_state(B, cuda)))
            finally:
                CG.GraphRunner._run = call
        assert torch.isfinite(losses[0]) and torch.equal(*losses)
        for p, q in zip(*(n.parameters() for n in nets)):
            assert torch.equal(p, q)
            assert (p.grad is None) == (q.grad is None)
            if p.grad is not None:
                assert torch.equal(p.grad, q.grad)
    (run,) = PFL._TRAIN_GRAPHS[opts[0]].values()
    assert run.graph is not None
    assert (gather.launches, fetch.launches) == before


@pytest.mark.cuda
def test_f_ctc_loss_refuses_capture(cuda):
    """Why the port does not use ``F.ctc_loss``: with tensor lengths it
    copies them to the host, which a capture refuses."""
    logits = torch.randn(T, B, PDFS, device=cuda).log_softmax(-1)
    labels = torch.randint(1, PDFS, (B, 4), device=cuda)
    lens = torch.full((B,), T, device=cuda)
    tlens = torch.full((B,), 4, device=cuda)
    torch.nn.functional.ctc_loss(logits, labels, lens, tlens)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="during CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            torch.nn.functional.ctc_loss(logits, labels, lens, tlens)


@pytest.mark.cuda
def test_adam_without_capturable_refuses_capture(cuda):
    p = torch.nn.Parameter(torch.ones(4, device=cuda))
    opt = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.ones_like(p)
    opt.step()
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="capturable"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            opt.step()
