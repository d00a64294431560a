"""The port's V1 session (``asr_decoder_tpu_torch/serving/v1_session.py``)
against the JAX package's ``V1AsrSession`` on the same model, graph and
waves, in realtime and end-compressed mode; mirrors
``tests/test_v1_session.py``.

Tolerance: segments (frame spans, frames fed to the AM), words, texts and
the SIL/AUDIO totals exact; costs within 1e-3 and alignment spans within
1e-6 s (the AM differs from JAX's in the last fp32 bits, which moves path
costs by ~1e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from asr_decoder_tpu.serving.v1_session import (  # noqa: E402
    V1AsrConfig as JaxV1Config, V1AsrSession as JaxV1Session)
from asr_decoder_tpu_torch.serving.session import \
    OnlineDecoderSession  # noqa: E402
from asr_decoder_tpu_torch.serving.v1_session import (  # noqa: E402
    V1AsrConfig, V1AsrSession)

from test_session import make_info, make_wave  # noqa: E402
from test_torch_serving import port_info  # noqa: E402
from test_v1_session import make_sil_speech_wave  # noqa: E402


@pytest.fixture(scope="module")
def infos():
    jinfo = make_info(seed=31)
    return jinfo, port_info(jinfo)


def both(infos, wave, chunks=None, **cfg):
    """The JAX and the port V1 session over ``wave`` (pushed in ``chunks``
    samples, then an empty EOS push; one push with EOS when None)."""
    out = []
    for cls, ccls, info in ((JaxV1Session, JaxV1Config, infos[0]),
                            (V1AsrSession, V1AsrConfig, infos[1])):
        s = cls(info, ccls(**cfg))
        if chunks is None:
            s.process_data(wave, eos=True)
        else:
            for lo in range(0, len(wave), chunks):
                s.process_data(wave[lo:lo + chunks])
            s.process_data(np.zeros(0, np.float32), eos=True)
        out.append(s)
    return out


def assert_same_results(j, p):
    assert len(p.results) == len(j.results)
    for pr, jr in zip(p.results, j.results):
        assert (pr["frame_span"], pr["frames"], pr["words"], pr["text"]) == \
            (jr["frame_span"], jr["frames"], jr["words"], jr["text"])
        assert pr["cost"] == pytest.approx(jr["cost"], abs=1e-3)
        assert [a[0] for a in pr["align"]] == [a[0] for a in jr["align"]]
        np.testing.assert_allclose([a[1:] for a in pr["align"]],
                                   [a[1:] for a in jr["align"]], atol=1e-6)
    assert (p.tot_sil_frames, p.tot_nosil_frames) == \
        (j.tot_sil_frames, j.tot_nosil_frames)
    assert p.frames_decoded() == j.frames_decoded()
    assert p.result_text() == j.result_text()


def test_realtime_matches_jax(infos):
    """Speech, a 1.2 s silence, speech, in uneven pushes: two segments,
    silence kept off the AM, everything equal to JAX."""
    wave, _ = make_sil_speech_wave(0)
    j, p = both(infos, wave, 7001, sil_frames_cut=40)
    assert_same_results(j, p)
    assert len(p.results) == 2
    assert p.frames_decoded() < (p.tot_sil_frames + p.tot_nosil_frames) \
        * 0.75


def test_partial_text_matches_jax(infos):
    wave, _ = make_sil_speech_wave(3)
    sessions = []
    for cls, ccls, info in ((JaxV1Session, JaxV1Config, infos[0]),
                            (V1AsrSession, V1AsrConfig, infos[1])):
        s = cls(info, ccls(sil_frames_cut=40))
        s.process_data(wave[:30000])
        sessions.append(s)
    j, p = sessions
    assert p.partial_text() == j.partial_text()
    assert len(p.results) == len(j.results) == 1


def test_end_compressed_matches_jax_and_realtime(infos):
    wave, _ = make_sil_speech_wave(1)
    kw = dict(sil_frames_cut=40, min_sil_frames_interval=40)
    j, p = both(infos, wave, use_realtime_vad=False, **kw)
    assert_same_results(j, p)
    rt = V1AsrSession(infos[1], V1AsrConfig(**kw))
    rt.process_data(wave, eos=True)
    assert [r["words"] for r in rt.results] == \
        [r["words"] for r in p.results]


def test_segments_equal_speech_only_decoding(infos):
    """Each segment decodes exactly the fed speech PCM (the port's own
    session on the segment's samples)."""
    _, pinfo = infos
    wave, _ = make_sil_speech_wave(0)
    p = V1AsrSession(pinfo, V1AsrConfig(sil_frames_cut=40))
    p.process_data(wave, eos=True)
    assert len(p.results) == 2
    shift = pinfo.vad_config.frame_shift_samp
    length = pinfo.vad_config.frame_length_samp
    for res in p.results:
        b, e = res["frame_span"]
        ref = OnlineDecoderSession(pinfo)
        ref.process_data(wave[b * shift:e * shift + (length - shift)],
                         eos=True)
        assert res["words"] == ref.get_best_path()["words"]
        assert res["frames"] == ref.num_frames_decoded


@pytest.mark.parametrize("case", ["short_gap", "max_nosil"])
def test_gap_merge_and_max_nosil_match_jax(infos, case):
    if case == "short_gap":
        rng = np.random.default_rng(5)
        wave = np.concatenate([
            (rng.standard_normal(8000) * 6000).astype(np.float32),
            np.zeros(2400, np.float32),
            (rng.standard_normal(8000) * 6000).astype(np.float32)])
        j, p = both(infos, wave, sil_frames_cut=40)
        assert len(p.results) == 1
    else:
        wave = make_wave(6, n=32000, amp=6000.0)
        j, p = both(infos, wave, sil_frames_cut=40, max_nosil_frames=60)
        assert len(p.results) >= 3
        assert all(r["frame_span"][1] - r["frame_span"][0] <= 60
                   for r in p.results)
    assert_same_results(j, p)
    assert p.nosil_rtf(1.0) == pytest.approx(j.nosil_rtf(1.0))
