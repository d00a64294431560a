"""The port's pitch frontend (``asr_decoder_tpu_torch/frontend/pitch.py``)
and the pitch branch of its pipeline against the JAX package's, on the same
seeded waves: the resampler, the NCCF, the Viterbi lag paths, the
post-processing, the stream against offline at EOS, ``ArbitraryResample``
and the composed fbank ‖ pitch (+ deltas) frontend.  Mirrors
``tests/test_pitch.py`` and ``tests/test_frontend_pipeline.py``.

Tolerance: pitch features, NCCF and resampled waves atol = rtol = 1e-4
(fp32 sums over windows in another order); Viterbi lag paths exact (ties
go to the first lag on both sides); fbank columns of the composed frontend
at ``tests/test_torch_frontend.py``'s fbank tolerance (atol 1e-3,
rtol 1e-5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.frontend import fbank as JF  # noqa: E402
from asr_decoder_tpu.frontend import pipeline as JP  # noqa: E402
from asr_decoder_tpu.frontend import pitch as JPI  # noqa: E402
from asr_decoder_tpu_torch.frontend import fbank as PF  # noqa: E402
from asr_decoder_tpu_torch.frontend import pipeline as PP  # noqa: E402
from asr_decoder_tpu_torch.frontend import pitch as PPI  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def sine(freq, secs=1.0, sr=16000, amp=5000.0):
    t = np.arange(int(secs * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def voiced(seed, secs=0.6):
    """A gliding two-harmonic tone in noise, with a silent stretch."""
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    f0 = 120 + 80 * t / secs
    ph = 2 * np.pi * np.cumsum(f0) / 16000
    x = 4000 * np.sin(ph) + 1500 * np.sin(2 * ph) \
        + 300 * rng.standard_normal(n)
    x[n // 3:n // 3 + 1600] = 0.0
    return x.astype(np.float32)


def lag_index(cfg, pitch):
    """The Viterbi path back from pitch = resample_freq / lag."""
    return np.rint(cfg.resample_freq / np.asarray(pitch)).astype(int) \
        - int(cfg.lags()[0])


def test_resample_and_nccf_match_jax():
    cfg = PPI.PitchConfig()
    wave = np.stack([sine(250.0, 0.5), voiced(0, 0.5)])
    jr = np.asarray(JPI.linear_resample(JPI.PitchConfig(),
                                        jnp.asarray(wave)))
    pr = PPI.linear_resample(cfg, torch.from_numpy(wave)).numpy()
    assert pr.shape == jr.shape == (2, 2000)
    np.testing.assert_allclose(pr, jr, atol=1e-3, rtol=1e-4)
    jn = JPI.compute_nccf(JPI.PitchConfig(), jnp.asarray(jr))
    pn = PPI.compute_nccf(cfg, torch.from_numpy(jr.copy()))
    for p, j in zip(pn, jn):
        assert p.shape == (2, 46, 71)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
    assert PPI.compute_nccf(cfg, torch.zeros(2, 150))[0].shape == (2, 0, 71)


def test_viterbi_matches_jax_with_ties():
    """Random local costs and exact ties (integer costs): the same path,
    the first lag winning every tie."""
    rng = np.random.default_rng(1)
    L = 9
    trans = rng.integers(0, 3, (L, L)).astype(np.float32)
    for T in (1, 2, 40):
        for local in (rng.random((3, T, L)).astype(np.float32),
                      rng.integers(0, 2, (3, T, L)).astype(np.float32)):
            want = np.asarray(JPI._viterbi_track(jnp.asarray(local),
                                                 jnp.asarray(trans), L))
            got = PPI._viterbi_track(torch.from_numpy(local),
                                     torch.from_numpy(trans)).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["100", "200", "333", "voiced", "noise"])
def test_compute_pitch_matches_jax(name):
    """Pitch and POV-NCCF within tolerance, lag paths equal; a sine is
    still tracked at its frequency (``tests/test_pitch.py``)."""
    if name == "noise":
        wave = (np.random.default_rng(0).standard_normal(16000) * 3000
                ).astype(np.float32)
    elif name == "voiced":
        wave = voiced(2, 1.0)
    else:
        wave = sine(float(name))
    cfg = PPI.PitchConfig()
    jp, jv = JPI.compute_pitch(JPI.PitchConfig(), wave[None])
    pp, pv = PPI.compute_pitch(cfg, wave[None])
    np.testing.assert_array_equal(lag_index(cfg, pp), lag_index(cfg, jp))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    if name not in ("voiced", "noise"):
        assert np.median(pp.numpy()[0, 10:-10]) == \
            pytest.approx(float(name), rel=0.05)


@pytest.mark.parametrize("kw", [{}, dict(add_raw_log_pitch=True,
                                         add_delta_pitch=False),
                                dict(normalization_left_context=3,
                                     delta_window=1)])
def test_process_pitch_matches_jax(kw):
    rng = np.random.default_rng(3)
    pitch = rng.uniform(60, 380, (2, 37)).astype(np.float32)
    pov = rng.uniform(-1, 1, (2, 37)).astype(np.float32)
    want = np.asarray(JPI.process_pitch(JPI.ProcessPitchConfig(**kw),
                                        jnp.asarray(pitch),
                                        jnp.asarray(pov)))
    got = PPI.process_pitch(PPI.ProcessPitchConfig(**kw),
                            torch.from_numpy(pitch),
                            torch.from_numpy(pov)).numpy()
    assert got.shape == want.shape == (2, 37, 3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        PPI.nccf_to_pov_feature(torch.from_numpy(pov)).numpy(),
        np.asarray(JPI.nccf_to_pov_feature(jnp.asarray(pov))), **TOL)


def test_stream_pitch_matches_jax_and_offline():
    """Every push of the stream equals JAX's stream; at EOS the whole
    stream equals the port's offline features (``tests/test_pitch.py``)."""
    cfg, pcfg = PPI.PitchConfig(), PPI.ProcessPitchConfig()
    wave = voiced(4, 1.5)
    offline = PPI.compute_and_process_pitch(cfg, pcfg, wave[None]).numpy()
    js = JPI.StreamPitch(JPI.PitchConfig(), JPI.ProcessPitchConfig())
    ps = PPI.StreamPitch(cfg, pcfg, device="cpu")
    outs = []
    for off in range(0, len(wave), 14000):
        end = off + 14000 >= len(wave)
        want = js.process_wave(wave[None, off:off + 14000], end=end)
        got = ps.process_wave(wave[None, off:off + 14000], end=end)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        outs.append(got)
    assert sum(o.shape[1] for o in outs[:-1]) > 0   # frames before EOS
    got = np.concatenate(outs, axis=1)
    assert got.shape == offline.shape
    np.testing.assert_allclose(got, offline, **TOL)


def test_merge_features_and_arbitrary_resample_match_jax():
    fb = np.random.default_rng(5).standard_normal((1, 10, 4)) \
        .astype(np.float32)
    pt = np.ones((1, 8, 3), np.float32)
    np.testing.assert_array_equal(PPI.merge_features(fb, pt),
                                  JPI.merge_features(fb, pt))
    sr, n = 4000.0, 800
    t = np.arange(n) / sr
    wave = (np.sin(2 * np.pi * 200 * t) + np.sin(2 * np.pi * 540 * t + 0.3)
            ).astype(np.float32)
    pts = np.sort(np.random.default_rng(0).uniform(0.05, (n - 200) / sr, 50))
    j = JPI.ArbitraryResample(n, sr, 1000.0, pts, num_zeros=10)
    p = PPI.ArbitraryResample(n, sr, 1000.0, pts, num_zeros=10, device="cpu")
    np.testing.assert_array_equal(p.weights.numpy(), np.asarray(j.weights))
    two = np.stack([wave, 2 * wave])
    np.testing.assert_allclose(p.resample(two).numpy(),
                               np.asarray(j.resample(two)), **TOL)
    with pytest.raises(ValueError):
        PPI.ArbitraryResample(n, sr, 3000.0, pts, device="cpu")


@pytest.mark.parametrize("delta", [0, 2])
def test_pitch_frontend_matches_jax(delta):
    """fbank16 ‖ pitch3 (+ order-2 deltas), streamed in the same chunks on
    both sides (``tests/test_frontend_pipeline.py``); the port's stream
    also equals its one-push run."""
    wave = voiced(6, 0.9)[None]
    jkw = dict(pitch_cfg=JPI.PitchConfig(),
               ppitch_cfg=JPI.ProcessPitchConfig(),
               delta_cfg=JP.DeltaConfig(order=delta, window=2))
    pkw = dict(pitch_cfg=PPI.PitchConfig(),
               ppitch_cfg=PPI.ProcessPitchConfig(),
               delta_cfg=PP.DeltaConfig(order=delta, window=2))
    jf = JP.StreamingFrontend(JF.FbankConfig(num_bins=16), **jkw)
    pf = PP.StreamingFrontend(PF.FbankConfig(num_bins=16), **pkw)
    assert pf.dim == jf.dim == 19 * (delta + 1)
    got, want = [], []
    for lo in range(0, wave.shape[1], 7201):
        end = lo + 7201 >= wave.shape[1]
        got.append(pf.accept(wave[:, lo:lo + 7201], end=end))
        want.append(np.asarray(jf.accept(wave[:, lo:lo + 7201], end=end)))
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape and got.shape[1] > 70
    # fbank columns at the fbank tolerance, pitch columns at TOL
    fbank_col = np.tile(np.arange(19) < 16, delta + 1)
    np.testing.assert_allclose(got[..., fbank_col], want[..., fbank_col],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[..., ~fbank_col], want[..., ~fbank_col],
                               **TOL)
    one = PP.StreamingFrontend(PF.FbankConfig(num_bins=16), **pkw)
    np.testing.assert_allclose(one.accept(wave, end=True), got, atol=1e-4)


def test_streaming_delta_order_zero_passes_through():
    feats = np.ones((1, 5, 3), np.float32)
    sd = PP.StreamingDelta(PP.DeltaConfig(order=0), batch=1)
    np.testing.assert_array_equal(sd.accept(feats), feats)
