"""The port's eval harness (``asr_decoder_tpu_torch/eval/harness.py``): it
trains and decodes on its own, and it agrees with the JAX harness on the
same trained weights.

Tolerances: training is held to the JAX test's own bounds at the same size
(``tests/test_eval_wer.py::test_train_decode_wer_parity``: loss < 3.0,
WER < 0.2, no gold mismatch).  With one set of weights in both packages the
hypotheses are equal word for word and the path costs agree within 1e-3
absolute (fp32 forward passes that sum in different orders, accumulated
over ~100 frames).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.decoder.config import DecoderConfig as JConfig  # noqa: E402
from asr_decoder_tpu.eval import harness as JH  # noqa: E402
from asr_decoder_tpu.eval.synth_task import SynthTask as JTask  # noqa: E402
from asr_decoder_tpu.models import layers as JL  # noqa: E402
from asr_decoder_tpu_torch.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu_torch.eval import harness as PH  # noqa: E402
from asr_decoder_tpu_torch.eval.synth_task import SynthTask  # noqa: E402
from asr_decoder_tpu_torch.models import nnet as PN  # noqa: E402

TASK = dict(num_phones=6, num_words=8, feat_dim=10, noise=0.25, seed=0)
TRAIN = dict(hidden=64, proj=32, num_layers=1, steps=700, batch=8,
             max_frames=96, max_label=20, lr=5e-3)
DECODE = dict(beam=16.0, beam_width=512, max_active=7000, min_active=64,
              arc_lanes=8)
EVAL = dict(num_utts=12, batch=4, max_frames=128, check_gold=6,
            keep_samples=12)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny and the test run has several workers: one
    intra-op thread is as fast and does not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_trained():
    return PH.train_ctc_model(SynthTask(**TASK), device="cpu", **TRAIN)


@pytest.fixture(scope="module")
def jax_trained():
    return JH.train_ctc_model(JTask(**TASK), **TRAIN)


def test_train_decode_wer_parity(port_trained):
    nnet, loss = port_trained
    assert loss < 3.0, f"CTC did not converge: loss={loss}"
    assert not any(p.requires_grad for p in nnet.parameters())
    res = PH.evaluate_wer(SynthTask(**TASK), nnet,
                          config=DecoderConfig(**DECODE), device="cpu",
                          **EVAL)
    assert res.wer.wer < 0.2, (res.wer.errors, res.wer.ref_len)
    assert res.gold_mismatches == 0
    assert res.gold_wer.errors <= res.wer.errors
    assert res.rtf > 0 and res.frames > 0
    # the beam the search kept, not the max_active it was asked for
    assert res.operating_point == dict(beam=16.0, beam_width=512,
                                       max_active=7000, min_active=64,
                                       effective_K=512)


def _same_results(jres, pres):
    assert len(jres.samples) == len(pres.samples) == EVAL["keep_samples"]
    for (jll, jhyp, jcost), (pll, phyp, pcost) in zip(jres.samples,
                                                      pres.samples):
        assert jhyp == phyp
        np.testing.assert_allclose(pcost, jcost, rtol=0, atol=1e-3)
        np.testing.assert_allclose(pll, jll, rtol=0, atol=1e-3)
    for k in ("errors", "ref_len", "subs", "ins", "dels"):
        assert getattr(jres.wer, k) == getattr(pres.wer, k)
    assert jres.frames == pres.frames
    assert jres.gold_mismatches == pres.gold_mismatches == 0


def test_jax_trained_layers_decode_the_same(jax_trained):
    """JAX-trained layers, carried across, through both ``evaluate_wer``."""
    layers, loss = jax_trained
    assert loss < 3.0
    jres = JH.evaluate_wer(JTask(**TASK), layers, config=JConfig(**DECODE),
                           **EVAL)
    nnet = PN.from_numpy_layers(
        [(l.kind, l.input_dim, l.output_dim, l.meta,
          {k: np.asarray(v) for k, v in l.params.items()}) for l in layers],
        device="cpu")
    pres = PH.evaluate_wer(SynthTask(**TASK), nnet,
                           config=DecoderConfig(**DECODE), device="cpu",
                           **EVAL)
    _same_results(jres, pres)


def test_port_trained_model_decodes_the_same_in_jax(port_trained):
    """The other way: a port-trained model handed to the JAX harness."""
    nnet, _ = port_trained
    layers = [JL.Layer({k: jnp.asarray(v) for k, v in params.items()}, kind,
                       din, dout, meta)
              for kind, din, dout, meta, params in PN.to_numpy_layers(nnet)]
    jres = JH.evaluate_wer(JTask(**TASK), layers, config=JConfig(**DECODE),
                           **EVAL)
    pres = PH.evaluate_wer(SynthTask(**TASK), nnet,
                           config=DecoderConfig(**DECODE), device="cpu",
                           **EVAL)
    _same_results(jres, pres)
    assert torch.is_tensor(next(nnet.parameters()))
