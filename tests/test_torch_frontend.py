"""The port's frontend (``asr_decoder_tpu_torch/frontend``) against the JAX
frontend on the same waveforms.

Tolerance: log-mel features allclose at atol 1e-3 (rtol 1e-5).  Both sides
are fp32, but the FFTs and the mel product sum in different orders; a
power of ~1e6-1e10 keeps ~7 digits, which is ~1e-6 relative and a few
1e-6 absolute after the log — 1e-3 leaves room for the quietest bins.
Within the port, streamed chunks reproduce the offline features exactly:
every frame is computed by the same ops on the same samples.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from asr_decoder_tpu.frontend import fbank as JF  # noqa: E402
from asr_decoder_tpu.frontend import pipeline as JP  # noqa: E402
from asr_decoder_tpu_torch.frontend import fbank as PF  # noqa: E402
from asr_decoder_tpu_torch.frontend import pipeline as PP  # noqa: E402


def _wave(seed=0, n=16000, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) * 3000).astype(np.float32)


def _cfgs(**kw):
    return JF.FbankConfig(**kw), PF.FbankConfig(**kw)


@pytest.mark.parametrize("kw", [
    {"num_bins": 16}, {"num_bins": 80},
    {"num_bins": 40, "window_type": "hamming", "use_power": False},
    {"num_bins": 23, "snip_edges": False, "preemphasis": 0.0,
     "remove_dc": False}])
def test_fbank_matches_jax(kw):
    jcfg, pcfg = _cfgs(**kw)
    wave = _wave()
    want = np.asarray(JF.compute_fbank(jcfg, wave))
    got = PF.compute_fbank(pcfg, wave).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_streaming_fbank_equals_offline():
    _, cfg = _cfgs(num_bins=16)
    wave = _wave(1, n=12345, batch=1)
    offline = PF.compute_fbank(cfg, wave).numpy()
    s = PF.StreamingFbank(cfg)
    outs, prev = [], 0
    for cut in (100, 401, 3000, 3001, 9000, 12345):
        outs.append(s.accept(wave[:, prev:cut], end=cut == 12345).numpy())
        prev = cut
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), offline)


def test_cmvn_matches_jax():
    feats = np.random.default_rng(2).standard_normal((2, 30, 8)).astype(
        np.float32) * 4 + 3
    for norm_var in (False, True):
        jc = JF.CmvnConfig(norm_var=norm_var)
        pc = PF.CmvnConfig(norm_var=norm_var)
        jy, (jm, jv) = JF.live_cmvn(jc, jnp.asarray(feats))
        py, (pm, pv) = PF.live_cmvn(pc, torch.from_numpy(feats))
        for p, j in ((py, jy), (pm, jm), (pv, jv)):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(
            PF.utterance_cmvn(torch.from_numpy(feats), norm_var).numpy(),
            np.asarray(JF.utterance_cmvn(jnp.asarray(feats), norm_var)),
            rtol=1e-5, atol=1e-5)


def test_streaming_frontend_matches_jax():
    """fbank + live CMVN + deltas, streamed in ragged chunks."""
    jcfg, pcfg = _cfgs(num_bins=16)
    delta = JP.DeltaConfig(order=2, window=2)
    jfront = JP.StreamingFrontend(jcfg, delta_cfg=delta,
                                  cmvn_cfg=JF.CmvnConfig())
    pfront = PP.StreamingFrontend(pcfg, delta_cfg=PP.DeltaConfig(2, 2),
                                  cmvn_cfg=PF.CmvnConfig())
    assert pfront.dim == jfront.dim == 48
    wave = _wave(3, n=9000, batch=1)
    got, want, prev = [], [], 0
    for cut in (1000, 1001, 5000, 9000):
        end = cut == 9000
        got.append(pfront.accept(wave[:, prev:cut], end=end))
        want.append(np.asarray(jfront.accept(wave[:, prev:cut], end=end)))
        prev = cut
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape and got.shape[1] > 50
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_pitch_not_ported():
    """Pitch, once refused, now runs: a one-push fbank ‖ pitch frontend
    equals JAX's (fbank columns at the fbank tolerance above, the three
    pitch columns at the pitch tolerance of ``tests/test_torch_pitch.py``,
    atol = rtol = 1e-4)."""
    from asr_decoder_tpu.frontend import pitch as JPI
    from asr_decoder_tpu_torch.frontend import pitch as PPI
    wave = _wave(4, n=12000, batch=1)
    jfront = JP.StreamingFrontend(JF.FbankConfig(num_bins=16),
                                  pitch_cfg=JPI.PitchConfig(),
                                  ppitch_cfg=JPI.ProcessPitchConfig())
    pfront = PP.StreamingFrontend(PF.FbankConfig(num_bins=16),
                                  pitch_cfg=PPI.PitchConfig(),
                                  ppitch_cfg=PPI.ProcessPitchConfig())
    want = np.asarray(jfront.accept(wave, end=True))
    got = pfront.accept(wave, end=True)
    assert got.shape == want.shape == (1, 73, 19)
    np.testing.assert_allclose(got[..., :16], want[..., :16], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 16:], want[..., 16:], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("stack", ["fbank", "fbank+cmvn+pitch+delta"])
def test_fbank_many_equals_each_stream_alone(stack):
    """Streams fed together through ``pipeline.fbank_many`` and their own
    ``finish`` give the features each one's ``accept`` gives alone: pushes
    of mixed lengths, an empty push, pushes shorter than a window (the
    carry crossing them), a short final push and EOS at different times.
    Both sides are fp32 over the same samples; the batched fbank stacks
    every stream's frames into one product, so a frame's sums may round
    differently: within a few fp32 ulps of the ~1e1 log-mel values."""
    from asr_decoder_tpu_torch.frontend import pitch as PPI
    kw = {}
    if stack != "fbank":
        kw = dict(pitch_cfg=PPI.PitchConfig(),
                  ppitch_cfg=PPI.ProcessPitchConfig(),
                  delta_cfg=PP.DeltaConfig(2, 2), cmvn_cfg=PF.CmvnConfig())

    def front():
        return PP.StreamingFrontend(PF.FbankConfig(num_bins=16), **kw)

    # each stream's push lengths; the last push of each carries EOS
    pushes = [[3200, 0, 3200, 1700, 3200, 900],
              [100, 150, 3200, 3200, 3200, 3200, 3200],
              [5000, 3200, 250],
              [3200, 3200, 3200, 3200, 3200, 3200, 3200, 80]]
    waves = [_wave(20 + i, n=sum(p), batch=1) for i, p in enumerate(pushes)]
    batched = [front() for _ in pushes]
    alone = [front() for _ in pushes]
    got = [[] for _ in pushes]
    want = [[] for _ in pushes]
    at = [0] * len(pushes)
    for k in range(max(map(len, pushes))):
        live = [i for i, p in enumerate(pushes) if k < len(p)]
        chunks = [waves[i][:, at[i]:at[i] + pushes[i][k]] for i in live]
        ends = [k == len(pushes[i]) - 1 for i in live]
        fbanks = PP.fbank_many([batched[i] for i in live], chunks, ends)
        for i, pcm, end, fb in zip(live, chunks, ends, fbanks):
            assert fb.shape[0] == 1 and fb.shape[2] == 16
            got[i].append(batched[i].finish(pcm, fb, end))
            want[i].append(alone[i].accept(pcm, end))
            at[i] += pushes[i][k]
    for g, w in zip(got, want):
        assert [x.shape for x in g] == [x.shape for x in w]
        g, w = np.concatenate(g, axis=1), np.concatenate(w, axis=1)
        assert g.shape[1] > 20
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


def test_compute_fbank_is_the_plain_arithmetic_bit_for_bit():
    """``compute_fbank`` (its per-frame arithmetic now in ``fbank_frames``,
    which the served path's batched fbank shares) gives, bit for bit, what
    the benchmark's plain copy of that arithmetic gives on the CPU."""
    from benchmark.reference import fbank as ref
    for bins in (16, 80):
        wave = _wave(5, n=16000, batch=3)
        got = PF.compute_fbank(PF.FbankConfig(num_bins=bins), wave)
        want = ref.fbank(torch.from_numpy(wave), bins)
        assert got.shape == want.shape == (3, 98, bins)
        assert torch.equal(got, want)
