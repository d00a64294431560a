"""The port's keyword wakeup (``asr_decoder_tpu_torch/wakeup/dtw.py``)
against the JAX package's on the same seeded posteriors: the DTW (totals
and the whole DP against the JAX function and the scalar oracle of
``tests/test_wakeup_align.py``), the keyword costs and the streaming
search's firing, confidence and range.

Tolerance: DTW costs atol 1e-5 (fp32 cumulative sums in another order);
firing and wake range exact; confidences within
1e-6 (exp of the normalized totals).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.wakeup import dtw as JD  # noqa: E402
from asr_decoder_tpu_torch.wakeup import dtw as PD  # noqa: E402

from test_wakeup_align import _posteriors, dtw_ref  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 5, 3), (2, 12, 7), (3, 1, 4),
                                   (4, 40, 6)])
def test_dtw_matches_jax_and_oracle(shape):
    rng = np.random.default_rng(0)
    cost = rng.random(shape).astype(np.float32) * 3
    jt, jdp = JD.dtw_align(cost)
    pt, pdp = PD.dtw_align(torch.from_numpy(cost))
    np.testing.assert_allclose(pdp.numpy(), np.asarray(jdp), atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    for b in range(shape[0]):
        np.testing.assert_allclose(pdp[b].numpy(), dtw_ref(cost[b]),
                                   rtol=1e-5)


def test_keyword_cost_matches_jax():
    post = np.random.default_rng(1).dirichlet(np.ones(10), size=(2, 6)) \
        .astype(np.float32)
    post[0, 0, 3] = 0.0                      # floored at 1e-10
    tpl = np.array([3, 1, 3])
    np.testing.assert_allclose(
        PD.keyword_cost(torch.from_numpy(post), tpl).numpy(),
        np.asarray(JD.keyword_cost(post, tpl)), atol=1e-5)


def streams():
    V, tpl = 10, np.array([2, 5, 7, 3])
    rng = np.random.default_rng(1)
    noise = np.full((20, V), 1.0 / V, np.float32)
    return {
        "keyword": (tpl, [noise, _posteriors(tpl, V)]),
        "keyword_late": (tpl, [rng.dirichlet(np.ones(V), 50)
                               .astype(np.float32),
                               _posteriors(tpl, V, hot=0.7, T_per=5)]),
        "noise": (tpl, [rng.dirichlet(np.ones(V), size=60)
                        .astype(np.float32)]),
    }


@pytest.mark.parametrize("name", ["keyword", "keyword_late", "noise"])
def test_wakeup_search_matches_jax(name):
    """The same posterior chunks through both searches: the firing of
    every chunk, the confidence and the wake range."""
    tpl, chunks = streams()[name]
    cfg = dict(window_frames=40, window_shift=4, min_frames=8,
               wake_threshold=0.5)
    j = JD.WakeupSearch(JD.WakeupConfig(**cfg), tpl)
    p = PD.WakeupSearch(PD.WakeupConfig(**cfg), tpl, device="cpu")
    for i, c in enumerate(chunks):
        end = i == len(chunks) - 1
        assert p.process_data(c, end=end) == j.process_data(c, end=end)
    assert p.woken == j.woken == (name != "noise")
    assert p.confidence == pytest.approx(j.confidence, abs=1e-6)
    assert p.wake_range == j.wake_range

