"""The port's VADs (``asr_decoder_tpu_torch/vad``) against the JAX package's
on the same seeded inputs: the energy VAD (energies, classes, the
hysteresis smoother, the stream at chunkings that cut frames mid-window),
the nnet VAD (silence probabilities, streamed decisions) and the segment
post-ops.

Tolerance: decisions, classes, flags, frame counts and segments exact;
energies rtol 1e-6 (fp32 sums in another order); nnet-VAD silence
probabilities atol 1e-5 (the AM layers differ from JAX's in the last fp32
bits, ``tests/test_torch_models.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.models import layers as JL  # noqa: E402
from asr_decoder_tpu.models.nnet import Nnet as JaxNnet  # noqa: E402
from asr_decoder_tpu.vad import energy as JE  # noqa: E402
from asr_decoder_tpu.vad import model_vad as JM  # noqa: E402
from asr_decoder_tpu_torch.models.nnet import from_numpy_layers  # noqa: E402
from asr_decoder_tpu_torch.vad import energy as PE  # noqa: E402
from asr_decoder_tpu_torch.vad import model_vad as PM  # noqa: E402


def port_nnet(jnnet, device="cpu"):
    """The port's Nnet with a JAX Nnet's layers and parameters."""
    return from_numpy_layers(
        [(l.kind, l.input_dim, l.output_dim, l.meta,
          {k: np.asarray(v) for k, v in l.params.items()})
         for l in jnnet.layers], device=device)


def speech_wave(seed, n=24000, batch=1):
    """Bursts of loud noise between stretches of quiet and of silence, so
    every energy class and both FSM transitions occur."""
    rng = np.random.default_rng(seed)
    amp = np.repeat(rng.choice([0.0, 200.0, 2000.0, 8000.0], (batch, n // 800
                                                             + 1)),
                    800, axis=1)[:, :n]
    return (rng.standard_normal((batch, n)) * amp).astype(np.float32)


@pytest.mark.parametrize("method", ["sum_square_root", "sum_abs"])
def test_frame_energy_and_classes_match_jax(method):
    wave = speech_wave(0, n=9001, batch=2)
    jc = JE.EnergyVadConfig(cal_method=method)
    pc = PE.EnergyVadConfig(cal_method=method)
    je = np.asarray(JE.frame_energy(jc, wave))
    pe = PE.frame_energy(pc, wave).numpy()
    assert pe.shape == je.shape == (2, 54)
    np.testing.assert_allclose(pe, je, rtol=1e-6)
    np.testing.assert_array_equal(
        PE.classify_energy(pc, torch.from_numpy(je.copy())).numpy(),
        np.asarray(JE.classify_energy(jc, jnp.asarray(je))))
    assert PE.frame_energy(pc, wave[:, :300]).shape == (2, 0)


def test_smooth_judge_matches_jax():
    """Random padded classes and initial flags: decisions and the final
    flag equal, for the energy config and a model-VAD judge config."""
    rng = np.random.default_rng(1)
    for cfgs in ((JE.EnergyVadConfig(), PE.EnergyVadConfig()),
                 (JM.VadJudgeConfig(left_frames=4, right_frames=3)
                  .to_energy_cfg(),
                  PM.VadJudgeConfig(left_frames=4, right_frames=3)
                  .to_energy_cfg())):
        for T in (0, 1, 7, 60):
            cls = rng.integers(0, 3, (3, T + cfgs[0].left_frames
                                      + cfgs[0].right_frames)).astype(
                np.int32)
            flag = rng.integers(0, 2, 3).astype(np.int32)
            jd, jf = JE.smooth_judge(cfgs[0], jnp.asarray(cls),
                                     jnp.asarray(flag))
            pd, pf = PE.smooth_judge(cfgs[1], torch.from_numpy(cls), flag)
            np.testing.assert_array_equal(pd, np.asarray(jd))
            np.testing.assert_array_equal(pf, np.asarray(jf))


@pytest.mark.parametrize("chunks", [(401, 3333, 137), (12000,)])
def test_energy_vad_stream_matches_jax(chunks):
    """The same wave pushed in the same chunks (sizes that end mid-frame
    and mid-window): every push's decisions, the SIL/AUDIO counts, and the
    stream against one offline push."""
    wave = speech_wave(2, n=12000, batch=2)
    j = JE.EnergyVadStream(JE.EnergyVadConfig(), batch=2)
    p = PE.EnergyVadStream(PE.EnergyVadConfig(), batch=2, device="cpu")
    got, lo, k = [], 0, 0
    while lo < wave.shape[1]:
        hi = lo + chunks[k % len(chunks)]
        end = hi >= wave.shape[1]
        jd = np.asarray(j.accept(wave[:, lo:hi], end=end))
        pd = p.accept(wave[:, lo:hi], end=end)
        np.testing.assert_array_equal(pd, jd)
        got.append(pd)
        lo, k = hi, k + 1
    assert (p.sil_frames, p.nosil_frames) == (j.sil_frames, j.nosil_frames)
    assert p.sil_frames > 20 and p.nosil_frames > 20
    off = PE.EnergyVadStream(PE.EnergyVadConfig(), batch=2, device="cpu")
    np.testing.assert_array_equal(np.concatenate(got, axis=1),
                                  off.accept(wave, end=True))


def test_segments_and_merge_match_jax():
    wave = speech_wave(3)
    dec = PE.EnergyVadStream(PE.EnergyVadConfig(), device="cpu").accept(
        wave, end=True)[0]
    segs = PE.vad_segments(dec)
    assert segs == JE.vad_segments(dec) and len(segs) > 3
    assert PE.vad_segments([]) == JE.vad_segments([]) == []
    for n in (3, 10, 40):
        assert PE.merge_short_sil(segs, n) == JE.merge_short_sil(segs, n)


# -- the nnet VAD ------------------------------------------------------------

def vad_nnet(seed=0, dim=8, lstm=True):
    """A small random VAD net with a splice, an affine, optionally a
    projected LSTM (streaming state), and a 3-way softmax; weights at
    unit scale so P(sil) spreads over (0, 1)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    layers = [JL.make_splice([-1, 0, 1], dim),
              JL.make_affine(ks[0], 3 * dim, 6, scale=1.0)]
    if lstm:
        layers.append(JL.make_lstm_projected(ks[1], 6, 8, 6))
    layers += [JL.make_affine(ks[2], 6, 3, scale=1.5), JL.make_softmax(3)]
    return JaxNnet(layers)


def spliced_feats(seed, T, dim=8, batch=1):
    rng = np.random.default_rng(seed)
    level = np.repeat(rng.normal(0, 2, (batch, T // 6 + 1, 1)), 6,
                      axis=1)[:, :T]
    return (rng.standard_normal((batch, T, 3 * dim)) + level).astype(
        np.float32)


@pytest.mark.parametrize("lstm", [False, True])
def test_sil_prob_matches_jax(lstm):
    jn = vad_nnet(lstm=lstm)
    jv = JM.VadNnet(jn, sil_pdfs=[0, 2])
    pv = PM.VadNnet(port_nnet(jn), sil_pdfs=[0, 2], device="cpu")
    assert pv.splice_offsets == jv.splice_offsets == (-1, 0, 1)
    feats = spliced_feats(4, 50, batch=2)
    js, pst = jv.init_state(2), pv.init_state(2)
    for lo, hi in ((0, 17), (17, 18), (18, 50)):   # state carries across
        jp, js = jv.sil_prob(jnp.asarray(feats[:, lo:hi]), js)
        pp, pst = pv.sil_prob(feats[:, lo:hi], pst)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
    assert 0.05 < float(np.asarray(jp).mean()) < 0.95


@pytest.mark.parametrize("chunks", [(17,), (5, 23, 1), (200,)])
def test_vad_nnet_stream_matches_jax(chunks):
    jn = vad_nnet(1)
    jstream = JM.VadNnetStream(JM.VadNnet(jn, [0, 2]),
                               JM.VadJudgeConfig(left_frames=4,
                                                 right_frames=4,
                                                 sil_prob_threshold=0.67))
    pstream = PM.VadNnetStream(PM.VadNnet(port_nnet(jn), [0, 2], device="cpu"),
                               PM.VadJudgeConfig(left_frames=4,
                                                 right_frames=4,
                                                 sil_prob_threshold=0.67))
    feats = spliced_feats(5, 90)
    lo, k, got = 0, 0, []
    while lo < feats.shape[1]:
        hi = lo + chunks[k % len(chunks)]
        end = hi >= feats.shape[1]
        jd = np.asarray(jstream.accept(feats[:, lo:hi], end=end))
        pd = pstream.accept(feats[:, lo:hi], end=end)
        np.testing.assert_array_equal(pd, jd)
        got.append(pd)
        lo, k = hi, k + 1
    dec = np.concatenate(got, axis=1)
    assert dec.shape == (1, 90)
    assert (pstream.sil_frames, pstream.nosil_frames) == \
        (jstream.sil_frames, jstream.nosil_frames)
    assert 0 < pstream.nosil_frames < 90
    assert PM.decisions_to_segments(dec[0]) == \
        JM.decisions_to_segments(dec[0])


def test_segment_post_ops_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(30):
        runs = rng.integers(1, 70, int(rng.integers(1, 9)))
        flag0 = int(rng.integers(0, 2))
        segs, beg = [], 0
        for i, n in enumerate(runs):
            segs.append(((flag0 + i) % 2, beg, beg + int(n)))
            beg += int(n)
        for n in (1, 10, 33):
            assert PM.compress_align_vad(segs, n) == \
                JM.compress_align_vad(segs, n)
            assert PM.merge_same_audio(segs, n) == \
                JM.merge_same_audio(segs, n)
            assert PM.restrict_max_nosil(segs, n) == \
                JM.restrict_max_nosil(segs, n)
