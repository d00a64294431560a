"""``pack_nonblank_frames`` and the layer constructors of the port
(``asr_decoder_tpu_torch/models/{nnet,layers}.py``) against JAX.

Tolerance: none for the packing (kept rows are copied, never computed);
rtol = atol = 1e-5 for a constructed layer's forward after carrying the JAX
constructor's weights across (fp32 on both sides, other summation order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.models import layers as JL  # noqa: E402
from asr_decoder_tpu.models import nnet as JN  # noqa: E402
from asr_decoder_tpu_torch.models import layers as PL  # noqa: E402
from asr_decoder_tpu_torch.models import nnet as PN  # noqa: E402


def _loglikes(case, rng):
    B, T, V = 5, 17, 6
    p = rng.dirichlet(np.ones(V) * 0.3, size=(B, T)).astype(np.float32)
    ll = np.log(p + 1e-6).astype(np.float32)
    if case == "ragged":
        ll[1, :, 0] = 0.0                 # every frame blank
        ll[2, :, 0] = -9.0                # no frame blank
        ll[3, 5:, 0] = 0.0                # blank tail
    elif case == "all_blank":
        ll[..., 0] = 0.0
    elif case == "none_blank":
        ll[..., 0] = -9.0
    return ll


@pytest.mark.parametrize("case,thresh,scale", [
    ("random", float(np.log(0.75)), 1.0),
    ("random", float(np.log(0.95)), 1.0),
    ("ragged", float(np.log(0.75)), 1.0),
    ("all_blank", float(np.log(0.75)), 1.0),
    ("none_blank", float(np.log(0.75)), 1.0),
    ("random", None, 1.0),                # the unnormalized-score default
    ("random", -3.0, 2.5),                # the acoustic scale on the score
])
def test_pack_nonblank_frames_exact(case, thresh, scale):
    ll = _loglikes(case, np.random.default_rng(3))
    if thresh is None:
        ll[:, ::3, 0] = 25.0              # above BLANK_SKIP_LOGPROB
    jp, jm = JN.pack_nonblank_frames(ll, 0, scale, thresh)
    pp, pm = PN.pack_nonblank_frames(torch.from_numpy(ll), 0, scale, thresh)
    assert pp.dtype == torch.float32 and pm.dtype == torch.bool
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(pp.numpy(), jp)
    if case == "all_blank":
        assert pp.shape[1] == 1 and not pm.any()
    if case == "ragged":
        assert jm[2].all() and not jm[1].any()


CONSTRUCTORS = {
    "linear": (lambda k: JL.make_linear(k, 7, 5),
               lambda g: PL.make_linear(g, 7, 5)),
    "lstm": (lambda k: JL.make_lstm(k, 7, 5),
             lambda g: PL.make_lstm(g, 7, 5)),
    "tf_lstm": (lambda k: JL.make_lstm(k, 7, 5, peephole=False),
                lambda g: PL.make_lstm(g, 7, 5, peephole=False)),
    "sru": (lambda k: JL.make_sru(k, 7, 7), lambda g: PL.make_sru(g, 7, 7)),
    "sigmoid": (lambda k: JL.make_sigmoid(7), lambda g: PL.make_sigmoid(7)),
    "add_shift": (lambda k: JL.make_add_shift(np.arange(7.0)),
                  lambda g: PL.make_add_shift(np.arange(7.0))),
    "rescale": (lambda k: JL.make_rescale(np.arange(7.0) - 3),
                lambda g: PL.make_rescale(np.arange(7.0) - 3)),
}


@pytest.mark.parametrize("kind", sorted(CONSTRUCTORS))
def test_constructor_matches_jax(kind):
    """Kind, dims, parameter names and shapes equal to the JAX
    constructor's; values drawn at the same scale; the forward equal after
    carrying the JAX weights across."""
    jmake, pmake = CONSTRUCTORS[kind]
    jl = jmake(jax.random.PRNGKey(0))
    pl = pmake(torch.Generator().manual_seed(0))
    assert (pl.kind, pl.input_dim, pl.output_dim, pl.meta) == \
        (jl.kind, jl.input_dim, jl.output_dim, jl.meta) and pl.kind == kind
    assert {k: tuple(v.shape) for k, v in pl.params.items()} == \
        {k: tuple(v.shape) for k, v in jl.params.items()}
    for name, v in pl.params.items():
        jv = np.asarray(jl.params[name])
        assert not v.requires_grad
        if name in ("shift", "scale") or not jv.any():
            np.testing.assert_array_equal(v.numpy(), jv)   # given or zeros
        else:                              # N(0, 0.05²) on both sides
            assert 0.02 < float(v.std()) < 0.09
    # the seed decides the weights
    again = pmake(torch.Generator().manual_seed(0))
    for a, b in zip(pl.parameters(), again.parameters()):
        assert torch.equal(a, b)
    carried = PN.from_numpy_layers(
        [(jl.kind, jl.input_dim, jl.output_dim, jl.meta,
          {k: np.asarray(v) for k, v in jl.params.items()})],
        device="cpu").layers[0]
    x = np.random.default_rng(1).standard_normal((2, 6, 7)).astype(np.float32)
    jy, _ = JL.layer_forward(jl, jnp.asarray(x), JL.init_layer_state(jl, 2))
    with torch.inference_mode():
        py, _ = carried(torch.from_numpy(x), carried.init_state(2))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
