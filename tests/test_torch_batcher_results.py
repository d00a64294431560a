"""The port arena's per-channel results (``get_word_alignment[_from]``,
``get_lattice``) against the JAX arena's and the port's own sessions on the
same seeded waves, and ``init_multihost``'s refusal to fall back to gloo.

Tolerance: alignments (words, begin and end seconds) and n-best texts equal
exactly.  Paths agree word for word and arc for arc across the packages
(``tests/test_torch_serving.py``), and a span's seconds are its frame
indices times ``info.seconds_per_frame``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from asr_decoder_tpu.serving.batcher import \
    BatchedStreamingDecoder as JaxArena  # noqa: E402
from asr_decoder_tpu_torch.parallel import multihost as PMH  # noqa: E402
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.session import (  # noqa: E402
    OnlineDecoderSession, nbest_from_lattice)

from test_session import make_info, make_wave  # noqa: E402
from test_torch_serving import (_decode, _feed_interleaved,  # noqa: E402
                                graph_infos, port_info)

WAVES = (6000, 4000, 5000)
CHUNKS = (2000, 1500, 1800)


def _infos(kind: str):
    if kind == "hclg":
        jinfo = make_info()
    elif kind == "hclg-skip2":
        from asr_decoder_tpu.models.nnet import AmConfig
        jinfo = make_info(am_config=AmConfig(skip=2), chunk_frames=18)
    else:
        return graph_infos(kind)
    return jinfo, port_info(jinfo)


def _arenas(jinfo, pinfo):
    """Both arenas fed the same waves in the same chunks, one channel a
    wave, and a fourth channel acquired and never fed."""
    waves = [make_wave(50 + i, n=n) for i, n in enumerate(WAVES)]
    out = []
    for cls, info in ((JaxArena, jinfo), (BatchedStreamingDecoder, pinfo)):
        eng = cls(info, num_channels=4)
        cids = [eng.acquire() for _ in waves]
        _feed_interleaved(eng, cids, waves, list(CHUNKS))
        out.append((eng, cids, eng.acquire()))
    return waves, out


@pytest.fixture(scope="module")
def fed():
    """kind → (port info, (JAX arena, its cids, its idle cid), (port arena,
    ...), the port's sessions over the same waves), built once a module."""
    cache = {}

    def get(kind: str):
        if kind not in cache:
            jinfo, pinfo = _infos(kind)
            waves, arenas = _arenas(jinfo, pinfo)
            cache[kind] = (pinfo, *arenas, [
                _decode(OnlineDecoderSession, pinfo, w) for w in waves])
        return cache[kind]
    yield get
    cache.clear()


ALIGNED = ["hclg", "hclg-skip2", "biglm-hclg"]


@pytest.mark.parametrize("frame_offset", [0, 37])
@pytest.mark.parametrize("kind", ALIGNED)
def test_word_alignment_matches_jax_arena_and_session(fed, kind,
                                                       frame_offset):
    _, (jeng, jcids, _), (eng, cids, _), sessions = fed(kind)
    for jcid, cid, s in zip(jcids, cids, sessions):
        got = eng.get_word_alignment(cid, frame_offset)
        assert got, "a fed channel aligns at least one word"
        assert got == jeng.get_word_alignment(jcid, frame_offset)
        assert got == s.get_word_alignment(frame_offset)
        assert eng.snapshot(cid).frames_decoded == s.num_frames_decoded
        assert eng.get_word_alignment_from(eng.snapshot(cid),
                                           frame_offset) == got
    if frame_offset:
        base = eng.get_word_alignment(cids[0])
        shift = frame_offset * eng.info.seconds_per_frame
        got = eng.get_word_alignment(cids[0], frame_offset)
        assert [w for w, _, _ in got] == [w for w, _, _ in base]
        np.testing.assert_allclose([b for _, b, _ in got],
                                   [b + shift for _, b, _ in base],
                                   rtol=0, atol=1e-9)


def test_clg_alignment_raises(fed):
    _, (jeng, jcids, _), (eng, cids, _), _ = fed("clg")
    with pytest.raises(RuntimeError, match="alignment"):
        jeng.get_word_alignment(jcids[0])
    with pytest.raises(RuntimeError, match="alignment"):
        eng.get_word_alignment(cids[0])
    with pytest.raises(RuntimeError, match="alignment"):
        eng.get_word_alignment_from(eng.snapshot(cids[0]), 5)


@pytest.mark.parametrize("kind", ["hclg", "biglm-hclg", "clg"])
def test_lattice_nbest_matches_jax_arena_and_session(fed, kind):
    pinfo, (jeng, jcids, jidle), (eng, cids, idle), sessions = fed(kind)
    for jcid, cid, s in zip(jcids, cids, sessions):
        lat = eng.get_lattice(cid)
        assert lat is not None and lat.num_states
        texts = [r["text"] for r in nbest_from_lattice(pinfo, lat, 3)]
        assert texts == [r["text"] for r in jeng.get_nbest(jcid, 3)]
        assert texts == s.get_nbest_txt(3)
        raw = eng.get_lattice(cid, determinize=False)
        jraw = jeng.get_lattice(jcid, determinize=False)
        assert (raw.num_states, raw.num_arcs) == (jraw.num_states,
                                                  jraw.num_arcs)
    assert eng.get_lattice(idle) is None
    assert jeng.get_lattice(jidle) is None


def test_init_multihost_needs_gloo_named_without_a_card(monkeypatch):
    """No backend and no visible card: a RuntimeError that names gloo,
    raised before any process group is made."""
    import torch
    import torch.distributed as dist

    def made(*a, **k):
        raise AssertionError("init_process_group was called")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", made)
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="gloo"):
            PMH.init_multihost("127.0.0.1:1", 2, 0, backend=backend)
    assert PMH.init_multihost().num_processes == 1
