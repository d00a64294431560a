"""Endpointing on the port's serve path (``asr_decoder_tpu_torch/serving``)
with the energy VAD on: session ``endpoint_detected`` sequences against the
JAX session's, the arena's endpoints and segment restarts against the
port's own sessions for every graph type, the server's ``MIDDLEEND``
replies with text and alignment accumulated across segments (mirrors
``tests/test_service.py:350``), and a session whose AM reads fbank ‖ pitch
with deltas against the JAX session.

Tolerance: endpoint flags, frame counts and words exact; costs within 1e-3
(the AM differs from JAX's in the last fp32 bits, which moves path costs by
~1e-5); alignment spans within 1e-6 s (they ride the wire as f32 seconds).
"""

import asyncio
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from asr_decoder_tpu.serving.client import AsyncAsrClient  # noqa: E402
from asr_decoder_tpu.serving.protocol import EndFlag  # noqa: E402
from asr_decoder_tpu.serving.session import \
    OnlineDecoderSession as JaxSession  # noqa: E402
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.server import (AsrServer,  # noqa: E402
                                                  SocketConfig)
from asr_decoder_tpu_torch.serving.session import (  # noqa: E402
    OnlineDecoderSession, word_alignment)

from test_session import make_info  # noqa: E402
from test_torch_serving import graph_infos, port_info  # noqa: E402

VAD = dict(use_energy_vad=True, endpoint_sil_frames=20,
           min_endpoint_frames=10)
PUSH = 1600


def speech_sil_speech(seed, parts=(8000, 8000, 8000)):
    """Loud noise, exact silence, loud noise (the ``tests/test_service.py``
    endpoint wave; ``parts`` sets each stretch's samples)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        (rng.standard_normal(parts[0]) * 4000).astype(np.float32),
        np.zeros(parts[1], np.float32),
        (rng.standard_normal(parts[2]) * 4000).astype(np.float32)])


def run_session(session, wave):
    """Push ``wave`` in ``PUSH``-sample chunks; restart the search at each
    endpoint as the server does.  Returns the endpoint flag of every push
    and, for each finished segment, (words, cost, frames decoded)."""
    flags, segs = [], []
    for lo in range(0, len(wave), PUSH):
        eos = lo + PUSH >= len(wave)
        session.process_data(wave[lo:lo + PUSH], eos=eos)
        ep = not eos and session.endpoint_detected()
        flags.append(ep)
        if ep or eos:
            best = session.get_best_path()
            segs.append((best["words"], best["cost"],
                         session.num_frames_decoded))
            if ep:
                session.init_decoding()
    return flags, segs


@pytest.fixture(scope="module")
def vad_infos():
    jinfo = make_info(**VAD)
    return jinfo, port_info(jinfo)


def run_arena(eng, cid, wave):
    """``run_session`` through one channel of an arena (either package's
    ``BatchedStreamingDecoder``), stepped as the server steps it."""
    flags, segs = [], []
    for lo in range(0, len(wave), PUSH):
        eos = lo + PUSH >= len(wave)
        eng.push(cid, wave[lo:lo + PUSH], eos=eos)
        while eng.pending_work():
            eng.step()
        ep = not eos and eng.endpoint_detected(cid)
        flags.append(ep)
        if ep or eos:
            snap = eng.snapshot(cid)
            best = eng.get_best_path_from(snap)
            segs.append((best["words"], best["cost"], snap.frames_decoded))
            if ep:
                eng.init_decoding(cid)
    return flags, segs


def test_session_endpoints_match_jax(vad_infos):
    """Every push's endpoint flag and every segment (words, cost, frames)
    equal the JAX arena's, whose restart keeps the frames not yet scored,
    as the port's session does; up to the first restart they also equal
    the JAX session's, whose restart drops those frames."""
    from asr_decoder_tpu.serving.batcher import BatchedStreamingDecoder as JB
    jinfo, pinfo = vad_infos
    wave = speech_sil_speech(11)
    jeng = JB(jinfo, num_channels=2)
    jflags, jsegs = run_arena(jeng, jeng.acquire(), wave)
    pflags, psegs = run_session(OnlineDecoderSession(pinfo), wave)
    assert pflags == jflags and sum(pflags) >= 1
    assert len(psegs) == len(jsegs) >= 2
    for (pw, pc, pn), (jw, jc, jn) in zip(psegs, jsegs):
        assert (pw, pn) == (jw, jn)
        assert pc == pytest.approx(jc, abs=1e-3)
    sflags, ssegs = run_session(JaxSession(jinfo), wave)
    first = pflags.index(True) + 1
    assert sflags[:first] == pflags[:first]
    assert ssegs[0][0] == psegs[0][0] and ssegs[0][2] == psegs[0][2]


def test_session_reset_clears_trailing_silence(vad_infos):
    _, pinfo = vad_infos
    s = OnlineDecoderSession(pinfo)
    wave = speech_sil_speech(13)
    s.process_data(wave[:16000])
    assert s.endpoint_detected()
    s.reset()
    assert not s.endpoint_detected() and s.num_frames_decoded == 0


def endpoint_graph(graph_type):
    if graph_type == "hclg":
        return port_info(make_info(**VAD))
    return graph_infos(graph_type, **VAD)[1]


@pytest.mark.parametrize("graph_type", ["hclg", "clg", "biglm-hclg"])
def test_batcher_endpoints_match_sessions(graph_type):
    """Two channels with their silences at different times, pushed in
    turns: every channel endpoints at the push its session does, and each
    segment after an ``init_decoding`` restart has the session's words,
    cost and frames — the beam row reset for this graph type's beam."""
    pinfo = endpoint_graph(graph_type)
    waves = [speech_sil_speech(20 + i, (6400 + 3200 * i, 8000, 4800))
             for i in range(2)]
    want = [run_session(OnlineDecoderSession(pinfo), w) for w in waves]
    eng = BatchedStreamingDecoder(pinfo, num_channels=4)
    cids = [eng.acquire() for _ in waves]
    got = [([], []) for _ in waves]
    for lo in range(0, max(map(len, waves)), PUSH):
        live = [i for i, w in enumerate(waves) if lo < len(w)]
        for i in live:
            eng.push(cids[i], waves[i][lo:lo + PUSH],
                     eos=lo + PUSH >= len(waves[i]))
        while eng.pending_work():
            eng.step()
        for i in live:
            eos = lo + PUSH >= len(waves[i])
            ep = not eos and eng.endpoint_detected(cids[i])
            got[i][0].append(ep)
            if ep or eos:
                snap = eng.snapshot(cids[i])
                best = eng.get_best_path_from(snap)
                got[i][1].append((best["words"], best["cost"],
                                  snap.frames_decoded))
                if ep:
                    eng.init_decoding(cids[i])
    for (gflags, gsegs), (wflags, wsegs) in zip(got, want):
        assert gflags == wflags and sum(gflags) >= 1
        assert [(w, n) for w, _, n in gsegs] == [(w, n) for w, _, n in wsegs]
        # the arena's AM runs at batch 4, the session's at 1: the products
        # may round differently in the last bit
        np.testing.assert_allclose([c for _, c, _ in gsegs],
                                   [c for _, c, _ in wsegs], atol=1e-3)


def serve(info, waves, **client_kw):
    """Stream each wave over its own connection in ``PUSH``-sample chunks,
    every chunk asking for ``client_kw``; returns every reply."""
    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    pcm = w.astype(np.int16)
                    return [await c.send_chunk(
                        pcm[lo:lo + PUSH], end=lo + PUSH >= len(pcm),
                        **client_kw) for lo in range(0, len(pcm), PUSH)]
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w) for w in waves))
        finally:
            await server.stop()
    return asyncio.run(run())


def test_server_endpoint_accumulates_text(vad_infos):
    """``MIDDLEEND`` at each endpoint; later replies carry the finished
    segments' words before their own; the final alignment is every
    segment's, each offset by the frames decoded before it."""
    _, pinfo = vad_infos
    waves = [speech_sil_speech(30), speech_sil_speech(31, (9600, 6400,
                                                           4800))]
    replies = serve(pinfo, waves, ali_info=True)
    for w, rs in zip(waves, replies):
        # the segments as a session sees them (pcm through int16, as sent)
        s = OnlineDecoderSession(pinfo)
        flags, segs = run_session(s, w.astype(np.int16).astype(np.float32))
        assert [r.end_flag == EndFlag.MIDDLEEND for r in rs] == flags
        assert rs[-1].end_flag == EndFlag.END
        words = [wd for seg in segs for wd in seg[0]]
        assert rs[-1].results[0].words == words
        assert rs[-1].one_best() == " ".join(pinfo.words.words(words))
        middle = [r for r in rs if r.end_flag == EndFlag.MIDDLEEND]
        assert middle and rs[-1].results[0].words[
            :len(middle[0].results[0].words)] == middle[0].results[0].words
        want, offset = [], 0
        s2 = OnlineDecoderSession(pinfo)
        for lo in range(0, len(w), PUSH):
            eos = lo + PUSH >= len(w)
            s2.process_data(w[lo:lo + PUSH].astype(np.int16)
                            .astype(np.float32), eos=eos)
            if eos or s2.endpoint_detected():
                want += word_alignment(pinfo, s2.get_best_path(), offset)
                offset += s2.num_frames_decoded
                s2.init_decoding()
        got = rs[-1].align
        assert [a[0] for a in got] == [a[0] for a in want]
        np.testing.assert_allclose([a[1:] for a in got],
                                   [a[1:] for a in want], atol=1e-6)


class RecordingArena:
    """The server's arena with every method call recorded: (method, thread
    id, thread name); ``snapshot`` results are kept by channel."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: list[tuple[str, int, str]] = []
        self.snaps: dict[int, list] = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def recorded(*args, **kw):
            self.calls.append((name, threading.get_ident(),
                               threading.current_thread().name))
            out = attr(*args, **kw)
            if name == "snapshot":
                self.snaps.setdefault(args[0], []).append(out)
            return out
        return recorded


def test_server_calls_the_arena_on_its_device_thread(vad_infos):
    """The arena has one writer: every arena method the server calls for
    two concurrent endpointed streams — ``endpoint_detected`` and
    ``init_decoding`` among them — runs on the one-thread device executor,
    never on the event loop, and the methods that build replies from
    snapshots run on the result pool.  A log flush racing ``step()`` would
    hand a tick's logs to a channel twice: each segment's
    ``frames_decoded`` equals a lone session's."""
    _, pinfo = vad_infos
    waves = [speech_sil_speech(40), speech_sil_speech(41, (9600, 6400,
                                                           9600))]
    seen = {}

    async def run():
        server = AsrServer(pinfo, SocketConfig(port=0, num_channels=4))
        arena = server._batcher = RecordingArena(server._batcher)
        seen["loop"] = threading.get_ident()
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    pcm = w.astype(np.int16)
                    return [await c.send_chunk(pcm[lo:lo + PUSH],
                                               end=lo + PUSH >= len(pcm))
                            for lo in range(0, len(pcm), PUSH)]
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w) for w in waves)), arena
        finally:
            await server.stop()

    replies, arena = asyncio.run(run())
    writers = {"acquire", "push", "step", "ready", "endpoint_detected",
               "snapshot", "init_decoding", "release"}
    readers = {"get_best_path_from", "get_nbest_from", "get_lattice_from"}
    called = {name for name, _, _ in arena.calls}
    assert writers <= called and called <= writers | readers, called
    device = {(tid, tname) for name, tid, tname in arena.calls
              if name in writers}
    assert len(device) == 1, device                 # one writer thread
    (tid, tname), = device
    assert tid != seen["loop"] and tname.startswith("device")
    for name, t, tn in arena.calls:
        assert t != seen["loop"], name              # nothing on the loop
        if name in readers:
            assert tn.startswith("results"), (name, tn)
    for name in ("endpoint_detected", "init_decoding"):
        assert sum(c[0] == name for c in arena.calls) >= 2
    # frames decoded per segment: the server's snapshots against a session
    by_pushes = {len(v): v for v in arena.snaps.values()}
    assert len(by_pushes) == 2
    for w, rs in zip(waves, replies):
        flags, segs = run_session(OnlineDecoderSession(pinfo),
                                  w.astype(np.int16).astype(np.float32))
        assert any(flags)
        snaps = by_pushes[len(rs)]
        ends = [i for i, r in enumerate(rs)
                if r.end_flag in (EndFlag.MIDDLEEND, EndFlag.END)]
        assert [rs[i].end_flag == EndFlag.MIDDLEEND for i in
                range(len(rs))] == flags
        assert [snaps[i].frames_decoded for i in ends] == \
            [frames for _, _, frames in segs]


def test_clg_server_endpoints_without_alignment():
    """A clg graph (no fst) endpoints and answers with no alignment."""
    pinfo = endpoint_graph("clg")
    (rs,) = serve(pinfo, [speech_sil_speech(32)], ali_info=True)
    assert any(r.end_flag == EndFlag.MIDDLEEND for r in rs)
    assert rs[-1].end_flag == EndFlag.END
    assert not any(r.ali_info or r.align for r in rs)


def test_pitch_delta_session_matches_jax():
    """A session whose AM reads fbank16 ‖ pitch3 with order-2 deltas
    (``tests/test_frontend_pipeline.py``): the same frames decoded and the
    same words as the JAX session, streamed in uneven pushes."""
    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.frontend.fbank import FbankConfig
    from asr_decoder_tpu.frontend.pipeline import DeltaConfig
    from asr_decoder_tpu.frontend.pitch import (PitchConfig,
                                                ProcessPitchConfig)
    from asr_decoder_tpu.fst.symbol import SymbolTable
    from asr_decoder_tpu.models.flagship import make_flagship
    from asr_decoder_tpu.serving.session import (OnlineDecoderConfig,
                                                 OnlineDecoderInfo)
    from test_beamsearch import random_decode_graph
    from test_session import make_wave
    rng = np.random.default_rng(33)
    fst = random_decode_graph(rng, num_states=40, num_labels=15)
    nnet = make_flagship(jax.random.PRNGKey(3), feat_dim=57, num_pdfs=16,
                         hidden=16, proj=8, num_layers=1, context=1)
    words = SymbolTable()
    words.add("<eps>", 0)
    for i in range(1, 6):
        words.add(f"w{i}", i)
    jinfo = OnlineDecoderInfo(
        nnet, fst, words, np.arange(16, dtype=np.int32),
        decoder_config=DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8,
                                     min_active=0),
        online_config=OnlineDecoderConfig(chunk_frames=16),
        fbank_config=FbankConfig(num_bins=16), pitch_config=PitchConfig(),
        process_pitch_config=ProcessPitchConfig(),
        delta_config=DeltaConfig(order=2, window=2))
    pinfo = port_info(jinfo)
    assert pinfo.make_frontend().dim == 57
    wave = make_wave(33, n=9000, amp=5000.0)
    got = []
    for cls, info in ((JaxSession, jinfo), (OnlineDecoderSession, pinfo)):
        s = cls(info)
        for lo in range(0, 9000, 5000):
            s.process_data(wave[lo:lo + 5000], eos=lo + 5000 >= 9000)
        got.append((s.num_frames_decoded, s.get_best_path()))
    (jn, jb), (pn, pb) = got
    assert pn == jn > 40
    assert pb["words"] == jb["words"]
    assert pb["cost"] == pytest.approx(jb["cost"], abs=1e-3)


def test_serve_cli_with_energy_vad(vad_infos, tmp_path):
    """``python -m asr_decoder_tpu_torch.cli.serve --device=cpu
    --use-energy-vad=true <nnet> <graph> <words>`` starts, and a stream
    with a silence in it gets a ``MIDDLEEND`` and then its ``END``, equal
    to a session of the same model."""
    import re
    import subprocess
    import sys
    _, pinfo = vad_infos
    paths = [str(tmp_path / n) for n in ("am.nnet", "graph.fst", "words")]
    pinfo.nnet.write_binary(paths[0])
    pinfo.fst.write_binary(paths[1])
    pinfo.words.write_text(paths[2])
    proc = subprocess.Popen(
        [sys.executable, "-m", "asr_decoder_tpu_torch.cli.serve",
         "--device=cpu", "--use-energy-vad=true", "--port=0",
         "--endpoint-sil-frames=20", "--min-endpoint-frames=10",
         "--beam=1e9", "--beam-width=64", "--min-active=0",
         "--lattice-beam=8", "--chunk-frames=16", "--fbank.num-bins=16",
         *paths], stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"listening on [\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "the server did not start"
        wave = speech_sil_speech(40)

        async def run():
            c = AsyncAsrClient("127.0.0.1", port)
            await c.connect()
            try:
                pcm = wave.astype(np.int16)
                return [await c.send_chunk(pcm[lo:lo + PUSH],
                                           end=lo + PUSH >= len(pcm))
                        for lo in range(0, len(pcm), PUSH)]
            finally:
                await c.close()
        rs = asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    flags, segs = run_session(OnlineDecoderSession(pinfo),
                              wave.astype(np.int16).astype(np.float32))
    assert [r.end_flag == EndFlag.MIDDLEEND for r in rs] == flags
    assert any(flags) and rs[-1].end_flag == EndFlag.END
    assert rs[-1].results[0].words == [w for s in segs for w in s[0]]
