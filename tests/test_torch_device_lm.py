"""The port's device n-gram LM (``asr_decoder_tpu_torch/lm/device_lm.py``)
on the CPU against the JAX ``asr_decoder_tpu/lm/device_lm.py`` and the host
``Fsa.get_arc`` backoff chase.

Tolerance: none against JAX for the tables, the hash and ``lm_get_arc`` —
the same numpy build gives the same arrays, and the lookup is int32
arithmetic (wrapping on overflow), exact gathers and fp32 adds in the same
order, so states and cost bits are equal.  ``DeviceDiffLm.advance``
computes ``lm2_scale·c2 − lm1_scale·c1``: with unit scales that is bit-
exact; with other scales XLA on the CPU contracts it into one fused
multiply-add (one rounding fewer) and torch does not, so the difference is
held to atol 1e-5 there.  Against the host ``Fsa.get_arc``, which sums
backoff weights in float64, costs agree to 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.lm import device_lm as J  # noqa: E402
from asr_decoder_tpu.lm.arpa import parse_arpa  # noqa: E402
from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text  # noqa: E402
from asr_decoder_tpu_torch.lm import device_lm as P  # noqa: E402

from test_lm import ARPA, ARPA2  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402


def _synth(seed=3):
    word2id = {f"w{i}": i for i in range(1, 41)}
    word2id.update({"<s>": 41, "</s>": 42})
    return parse_arpa(synth_arpa_text(vocab_size=40, n_bigram=300,
                                      n_trigram=200, seed=seed),
                      word2id=word2id)


@pytest.fixture(scope="module")
def fsas():
    fsa1 = parse_arpa(ARPA)
    fsa2 = parse_arpa(ARPA2, word2id=fsa1.vocab)
    return {"arpa": fsa1, "arpa2": fsa2, "synth": _synth()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("which", ["arpa", "arpa2", "synth"])
def test_tables_match_jax(fsas, which):
    """The state carried across from JAX: the same host Fsa (the port's
    copy, carried across as arrays) builds the same tables and bounds,
    array for array."""
    fsa = fsas[which]
    pfsa = to_port(fsa)
    j, p = J.DeviceNgramLm.build(fsa), P.DeviceNgramLm.build(pfsa, "cpu")
    for name in ("table", "uni", "backoff"):
        t = getattr(p, name)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      t.numpy())
    for name in ("start", "root", "levels", "max_probes", "mask"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.fsa is pfsa


def test_hash2_matches_jax_with_overflow():
    """int32 wraparound parity: states and words across the whole int32
    range, so ``s·H1`` and ``w·H2`` overflow and go negative, and ``>>`` is
    an arithmetic shift of negative numbers."""
    rng = np.random.default_rng(0)
    s = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    w = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    s[:4] = [2**31 - 1, -2**31, 0, 1]
    w[:4] = [2**31 - 1, -2**31, -1, 2**20]
    wide = s.astype(np.int64) * J._H1
    assert ((wide < -2**31) | (wide >= 2**31)).mean() > 0.9
    for mask in (15, 2**10 - 1, 2**20 - 1, 2**31 - 1):
        want = np.asarray(J._hash2(jax.numpy.asarray(s), jax.numpy.asarray(w),
                                   jax.numpy.int32(mask)))
        got = P._hash2(torch.from_numpy(s), torch.from_numpy(w), mask)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(P._hash2(s, w, np.int32(mask)),
                                          want)


@pytest.mark.parametrize("which", ["arpa", "arpa2", "synth"])
def test_get_arc_matches_jax_and_host(fsas, which):
    """Every (state, word) pair — unseen words, ``w <= 0`` and words past
    the vocabulary whose hashes overflow — against JAX bit for bit, and
    against the host backoff chase."""
    fsa = fsas[which]
    j = J.DeviceNgramLm.build(fsa)
    p = P.DeviceNgramLm.build(to_port(fsa), "cpu")
    S, V = fsa.num_states, max(fsa.vocab.values())
    words = np.concatenate([np.arange(-2, V + 4), [2**20, 2**31 - 1]])
    s, w = (a.ravel().astype(np.int32)
            for a in np.meshgrid(np.arange(S), words))
    jd, jc = J.lm_get_arc(j, s, w)
    pd, pc = P.lm_get_arc(p, torch.from_numpy(s[None]),
                          torch.from_numpy(w[None]))
    assert pd.shape == pc.shape == (1, len(s))
    np.testing.assert_array_equal(pd.numpy()[0], np.asarray(jd))
    np.testing.assert_array_equal(_bits(pc.numpy()[0]), _bits(jc))
    pd, pc = pd.numpy()[0], pc.numpy()[0]
    for i in range(len(s)):
        if w[i] <= 0:
            assert pd[i] == s[i] and pc[i] == 0.0
        else:
            hd, hc = fsa.get_arc(int(s[i]), int(w[i]))
            assert pd[i] == hd, (s[i], w[i])
            assert pc[i] == pytest.approx(hc, abs=1e-5)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (0.7, 1.3)])
def test_diff_lm_matches_jax(fsas, scales):
    fsa1, fsa2 = fsas["arpa"], fsas["arpa2"]
    j = J.DeviceDiffLm.build(fsa1, fsa2, *scales)
    p = P.DeviceDiffLm.build(to_port(fsa1), to_port(fsa2), *scales,
                             device="cpu")
    assert p.start == j.start
    rng = np.random.default_rng(5)
    n = 500
    s1 = rng.integers(0, fsa1.num_states, n).astype(np.int32)
    s2 = rng.integers(0, fsa2.num_states, n).astype(np.int32)
    w = rng.integers(-1, max(fsa1.vocab.values()) + 2, n).astype(np.int32)
    jn1, jn2, jc = (np.asarray(x) for x in j.advance(s1, s2, w))
    pn1, pn2, pc = (x.numpy() for x in p.advance(
        *map(torch.from_numpy, (s1, s2, w))))
    np.testing.assert_array_equal(pn1, jn1)
    np.testing.assert_array_equal(pn2, jn2)
    if scales == (1.0, 1.0):
        np.testing.assert_array_equal(_bits(pc), _bits(jc))
    else:
        np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-5)
    for a in range(fsa1.num_states):
        for b in range(fsa2.num_states):
            assert p.final_host(a, b) == j.final_host(a, b)
