"""The port's AM (``asr_decoder_tpu_torch/models``) against the JAX layers on
the same weights, carried over with ``from_numpy_layers``.

Tolerance: fp32 allclose at rtol = atol = 1e-5 for single layers and 1e-4
(absolute, log domain) for the whole ``am_forward``.  Both sides compute in
fp32, but XLA's and PyTorch's CPU matrix products sum in different orders,
which moves the last bits; the recurrences carry those differences across
frames.  The binary model format is held byte for byte.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.models import layers as JL  # noqa: E402
from asr_decoder_tpu.models import nnet as JN  # noqa: E402
from asr_decoder_tpu.models.flagship import make_flagship  # noqa: E402
from asr_decoder_tpu_torch.models import nnet as PN  # noqa: E402
from asr_decoder_tpu_torch.models.flagship import \
    make_flagship as port_flagship  # noqa: E402

D, H, P = 12, 10, 6   # input, hidden, projection widths


def _params(kind, rng):
    n = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return {
        "splice": ({}, D, 3 * D, (-1, 0, 1)),
        "add_shift": ({"shift": n(D)}, D, D, ()),
        "rescale": ({"scale": n(D)}, D, D, ()),
        "sigmoid": ({}, D, D, ()),
        "softmax": ({}, D, D, ()),
        "prior": ({"log_priors": n(D)}, D, D, ()),
        "affine": ({"weight": n(H, D), "bias": n(H)}, D, H, ()),
        "linear": ({"weight": n(H, D)}, D, H, ()),
        "lstm": ({"w_gifo_x": n(4 * H, D), "w_gifo_m": n(4 * H, H),
                  "bias": n(4 * H), "phole_i": n(H), "phole_f": n(H),
                  "phole_o": n(H)}, D, H, ()),
        "lstm_cudnn": ({"w_gifo_x": n(4 * H, D), "w_gifo_m": n(4 * H, H),
                        "bias": n(4 * H), "phole_i": n(H), "phole_f": n(H),
                        "phole_o": n(H)}, D, H, ()),
        "tf_lstm": ({"w_gifo_x": n(4 * H, D), "w_gifo_m": n(4 * H, H),
                     "bias": n(4 * H)}, D, H, ()),
        "lstm_projected": ({"w_gifo_x": n(4 * H, D), "w_gifo_r": n(4 * H, P),
                            "bias": n(4 * H), "phole_i": n(H),
                            "phole_f": n(H), "phole_o": n(H),
                            "w_r_m": n(P, H)}, D, P, ()),
        "sru": ({"w_xfrh": n(4 * D, D), "bias_f": n(D), "bias_r": n(D)},
                D, D, ()),
    }[kind]


def _carry(layers):
    """JAX layers → the tuples ``from_numpy_layers`` takes."""
    return [(l.kind, l.input_dim, l.output_dim, l.meta,
             {k: np.asarray(v) for k, v in l.params.items()})
            for l in layers]


@pytest.mark.parametrize("kind", sorted(JL.KIND_IDS))
def test_layer_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    params, din, dout, meta = _params(kind, rng)
    jl = JL.Layer({k: jnp.asarray(v) for k, v in params.items()}, kind, din,
                  dout, meta)
    pl = PN.from_numpy_layers(_carry([jl]), device="cpu").layers[0]
    x = rng.standard_normal((3, 7, din)).astype(np.float32)
    # recurrent layers start from a non-zero carry, as mid-stream
    jstate = jax.tree.map(
        lambda z: jnp.asarray(rng.standard_normal(z.shape), jnp.float32),
        JL.init_layer_state(jl, 3))
    pstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    assert sorted(pl.init_state(3)) == sorted(jstate)
    jy, jst = JL.layer_forward(jl, jnp.asarray(x), jstate)
    with torch.inference_mode():
        py, pst = pl(torch.from_numpy(x), pstate)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in jst:
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-5)


def _small_flagship(seed=0):
    return make_flagship(jax.random.PRNGKey(seed), feat_dim=16, num_pdfs=16,
                         hidden=16, proj=8, num_layers=2, context=1)


@pytest.mark.parametrize("kw", [
    {}, {"skip": 2}, {"skip": 2, "skip_copy": True},
    {"block_pdf_pdfid": 0, "skip_block": 0.05},
    {"do_softmax": False, "do_log": False, "sub_prior": False}])
def test_am_forward_matches_jax(kw):
    jnet = _small_flagship()
    pnet = PN.from_numpy_layers(_carry(jnet.layers), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 11, 16)).astype(
        np.float32)
    jy, jst = JN.am_forward(jnet.layers, jnp.asarray(x), jnet.init_state(2),
                            **kw)
    with torch.inference_mode():
        py, pst = PN.am_forward(pnet.layers, torch.from_numpy(x),
                                pnet.init_state(2), **kw)
    assert py.shape == jy.shape
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-4)
    for js, ps in zip(jst, pst):
        for k in js:
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]),
                                       rtol=0, atol=1e-4)
    mask_j = np.asarray(JN.blank_frame_mask(jy, 0, 3.0))
    mask_p = PN.blank_frame_mask(py, 0, 3.0).numpy()
    np.testing.assert_array_equal(mask_p, mask_j)


def test_binary_format_shared(tmp_path):
    """A model file written by either package reads in the other and
    writes back byte-identical; the forward agrees."""
    jnet = _small_flagship(3)
    jnet.layers.insert(1, JL.Layer({"shift": jnp.ones(48)}, "add_shift",
                                   48, 48))
    jpath, ppath = tmp_path / "jax.nnet", tmp_path / "port.nnet"
    jnet.write_binary(str(jpath))
    pnet = PN.Nnet.read_binary(str(jpath), device="cpu")
    pnet.write_binary(str(ppath))
    assert jpath.read_bytes() == ppath.read_bytes()
    assert [l.kind for l in pnet.layers] == [l.kind for l in jnet.layers]
    assert pnet.context() == jnet.context()
    x = np.random.default_rng(2).standard_normal((2, 6, 16)).astype(
        np.float32)
    jy, _ = JN.am_forward(jnet.layers, jnp.asarray(x), jnet.init_state(2))
    with torch.inference_mode():
        py, _ = PN.am_forward(pnet.layers, torch.from_numpy(x),
                              pnet.init_state(2))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-4)


def test_port_flagship_shape_and_seed():
    a = port_flagship(7, feat_dim=16, num_pdfs=32, hidden=16, proj=8,
                      num_layers=2, device="cpu")
    b = port_flagship(7, feat_dim=16, num_pdfs=32, hidden=16, proj=8,
                      num_layers=2, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        y, _ = PN.am_forward(a.layers, x, a.init_state(2))
    assert y.shape == (2, 9, 32) and torch.isfinite(y).all()
    # log posteriors minus a uniform log prior sum to 1 after exp
    torch.testing.assert_close(
        (y + np.log(1 / 32)).exp().sum(-1), torch.ones(2, 9))
