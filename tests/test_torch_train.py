"""The port's CTC training step (``asr_decoder_tpu_torch/models/flagship.py``)
against the JAX one on the same weights, carried across with
``from_numpy_layers`` / ``to_numpy_layers``.

Tolerances: one step's loss within 1e-4 relative (the port's loss is
optax's op for op; ``exp`` and ``log1p`` round otherwise); every
gradient within 1e-3 relative + 1e-5 absolute, by parameter name; the
parameters after five Adam steps within 1e-3 absolute (Adam divides by
sqrt(v): a last-bit difference of a near-zero gradient can move one update
by a fraction of lr = 1e-3, so the bound is lr).  ``gradcheck`` runs in
float64 with its default tolerances.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.eval.synth_task import SynthTask  # noqa: E402
from asr_decoder_tpu.models import flagship as JFL  # noqa: E402
from asr_decoder_tpu.models import layers as JL  # noqa: E402
from asr_decoder_tpu.models.nnet import Nnet as JNnet  # noqa: E402
from asr_decoder_tpu_torch.models import flagship as PFL  # noqa: E402
from asr_decoder_tpu_torch.models import layers as PL  # noqa: E402
from asr_decoder_tpu_torch.models import nnet as PN  # noqa: E402

B, T, LMAX = 4, 40, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny and the test run has several workers: one
    intra-op thread is as fast and does not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(layers):
    """JAX layers → the tuples ``from_numpy_layers`` takes."""
    return [(l.kind, l.input_dim, l.output_dim, l.meta,
             {k: np.asarray(v) for k, v in l.params.items()})
            for l in layers]


def to_jax_layers(tuples):
    """``to_numpy_layers`` tuples → JAX layers."""
    return [JL.Layer({k: jnp.asarray(v) for k, v in params.items()}, kind,
                     din, dout, meta)
            for kind, din, dout, meta, params in tuples]


@pytest.fixture(scope="module")
def setup():
    task = SynthTask(num_phones=6, num_words=8, feat_dim=10, seed=0)
    jnet = JFL.make_flagship(jax.random.PRNGKey(0), feat_dim=task.feat_dim,
                             num_pdfs=task.num_phones + 1, hidden=16, proj=8,
                             num_layers=2, context=1)
    rng = np.random.default_rng(1)
    batches = [task.sample_batch(rng, B, T, LMAX) for _ in range(5)]
    return jnet, batches


def _tensors(batch):
    x, labels, pads = batch
    return (torch.from_numpy(np.asarray(x, np.float32)),
            torch.from_numpy(np.asarray(labels)),
            torch.from_numpy(np.asarray(pads, np.float32)))


def test_loss_and_gradients_match_jax(setup):
    jnet, batches = setup
    x, labels, pads = batches[0]
    jloss, jgrads = jax.value_and_grad(JFL.ctc_loss_fn)(
        jnet.layers, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(pads),
        jnet.init_state(B))
    pnet = PN.from_numpy_layers(carry(jnet.layers), device="cpu")
    pnet.requires_grad_(True)
    loss = PFL.ctc_loss_fn(pnet.layers, *_tensors(batches[0]),
                           pnet.init_state(B))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    seen = 0
    for i, (jl, pl) in enumerate(zip(jgrads, pnet.layers)):
        assert sorted(jl.params) == sorted(pl.params)
        for name, jg in jl.params.items():
            pg = getattr(pl, name).grad
            if pl.kind == "prior":          # the training head stops before it
                assert pg is None and not np.asarray(jg).any()
                continue
            np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{i}.{name}")
            assert np.abs(np.asarray(jg)).max() > 0
            seen += 1
    assert seen == 2 + 7 * 2 + 2     # affine, two projected LSTMs, affine


def test_five_adam_steps_match_jax(setup):
    jnet, batches = setup
    lr = 1e-3
    pnet = PN.from_numpy_layers(carry(jnet.layers), device="cpu")
    opt = PFL.init_opt_state(pnet, lr)
    # the JAX step donates its layers: give it copies
    layers = to_jax_layers(carry(jnet.layers))
    opt_state = JFL.init_opt_state(layers, lr)
    state = jnet.init_state(B)
    jlosses, plosses = [], []
    for batch in batches:
        x, labels, pads = batch
        layers, opt_state, jloss = JFL.ctc_train_step(
            layers, opt_state, jnp.asarray(x), jnp.asarray(labels),
            jnp.asarray(pads), state, lr)
        jlosses.append(float(jloss))
        plosses.append(float(PFL.ctc_train_step(
            pnet, opt, *_tensors(batch), pnet.init_state(B))))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    before = carry(jnet.layers)
    moved = 0.0
    for (kind, _, _, _, pp), jl, b in zip(PN.to_numpy_layers(pnet), layers,
                                          before):
        assert kind == jl.kind and sorted(pp) == sorted(jl.params)
        for name, v in pp.items():
            np.testing.assert_allclose(v, np.asarray(jl.params[name]),
                                       rtol=0, atol=1e-3,
                                       err_msg=f"{kind}.{name}")
            moved = max(moved, float(np.abs(v - b[4][name]).max()))
    assert moved > 3e-3              # five steps of lr 1e-3 did move weights


def test_to_numpy_layers_round_trip(setup):
    jnet, _ = setup
    tuples = carry(jnet.layers)
    back = PN.to_numpy_layers(PN.from_numpy_layers(tuples, device="cpu"))
    assert len(back) == len(tuples)
    for a, b in zip(tuples, back):
        assert a[:4] == b[:4] and sorted(a[4]) == sorted(b[4])
        for k in a[4]:
            np.testing.assert_array_equal(a[4][k], b[4][k])
    # and a JAX Nnet built from them runs
    jn = JNnet(to_jax_layers(back))
    assert jn.output_dim == jnet.output_dim


@pytest.mark.parametrize("kind", ["lstm_projected", "lstm", "sru"])
def test_recurrence_gradcheck(kind):
    """The frame loop under autograd, in float64 at B = 2, T = 3, H = 4."""
    gen = torch.Generator().manual_seed(0)
    layer = {"lstm_projected": lambda: PL.make_lstm_projected(gen, 3, 4, 2,
                                                              scale=0.5),
             "lstm": lambda: PL.make_lstm(gen, 3, 4, scale=0.5),
             "sru": lambda: PL.make_sru(gen, 3, 3, scale=0.5)}[kind]()
    layer = layer.double().requires_grad_(True)
    x = torch.randn(2, 3, 3, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    state = {k: torch.randn(v.shape, dtype=torch.float64, generator=gen)
             for k, v in layer.init_state(2).items()}
    names, params = zip(*layer.named_parameters())

    def fn(x, *ps):
        out, st = torch.func.functional_call(layer, dict(zip(names, ps)),
                                             (x, state))
        return (out,) + tuple(st.values())

    assert torch.autograd.gradcheck(fn, (x,) + params)


def test_serving_runs_without_grad_after_training(setup):
    """A training step leaves gradients on; ``requires_grad_(False)`` hands
    the model back to serving, whose forward builds no graph and equals the
    forward under ``inference_mode`` of the same weights."""
    jnet, batches = setup
    pnet = PN.from_numpy_layers(carry(jnet.layers), device="cpu")
    assert not any(p.requires_grad for p in pnet.parameters())
    opt = PFL.init_opt_state(pnet, 1e-3)
    loss = PFL.ctc_train_step(pnet, opt, *_tensors(batches[0]),
                              pnet.init_state(B))
    assert not loss.requires_grad and torch.isfinite(loss)
    assert all(p.requires_grad for p in pnet.parameters())
    x = _tensors(batches[0])[0]
    with torch.inference_mode():
        y_inf, _ = PN.am_forward(pnet.layers, x, pnet.init_state(B))
    assert not y_inf.requires_grad
    pnet.requires_grad_(False)
    y, _ = PN.am_forward(pnet.layers, x, pnet.init_state(B))
    assert not y.requires_grad and y.grad_fn is None
    assert torch.equal(y, y_inf)
