"""The port's serve path (``asr_decoder_tpu_torch/serving``) on the CPU:
sessions against the JAX sessions on the same model, graph and waves; the
batched arena against the port's own sessions; the TCP server against the
port's batcher; and the package's independence from JAX.

Tolerance: words equal; costs within 1e-3.  The AM differs from JAX's in
the last fp32 bits (``tests/test_torch_models.py``), which moves path
costs by ~1e-5; within the port the arena and a session run the same ops,
so their words agree exactly.
"""

import asyncio
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from asr_decoder_tpu.serving.client import AsyncAsrClient  # noqa: E402
from asr_decoder_tpu.serving.protocol import EndFlag  # noqa: E402
from asr_decoder_tpu.serving.session import \
    OnlineDecoderSession as JaxSession  # noqa: E402
from asr_decoder_tpu_torch.frontend.fbank import FbankConfig  # noqa: E402
from asr_decoder_tpu_torch.models.nnet import (AmConfig,  # noqa: E402
                                               from_numpy_layers)
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.server import (AsrServer,  # noqa: E402
                                                  SocketConfig)
from asr_decoder_tpu_torch.serving.session import (  # noqa: E402
    OnlineDecoderConfig, OnlineDecoderInfo, OnlineDecoderSession)

from test_session import make_info, make_wave  # noqa: E402


def port_info(jinfo) -> OnlineDecoderInfo:
    """The port's info over the JAX info's model, graph and configs."""
    layers = [(l.kind, l.input_dim, l.output_dim, l.meta,
               {k: np.asarray(v) for k, v in l.params.items()})
              for l in jinfo.nnet.layers]
    return OnlineDecoderInfo(
        from_numpy_layers(layers), jinfo.fst, jinfo.words, jinfo.ilabel2pdf,
        decoder_config=jinfo.decoder_config,
        online_config=OnlineDecoderConfig(**asdict(jinfo.config)),
        fbank_config=FbankConfig(**asdict(jinfo.fbank_config)),
        am_config=AmConfig(**asdict(jinfo.am_config)), device="cpu")


@pytest.fixture(scope="module")
def infos():
    jinfo = make_info()
    return jinfo, port_info(jinfo)


def _decode(session_cls, info, wave, splits=()):
    s = session_cls(info)
    prev = 0
    for cut in splits:
        s.process_data(wave[prev:cut])
        prev = cut
    s.process_data(wave[prev:], eos=True)
    return s


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_session_matches_jax_session(infos, seed):
    jinfo, pinfo = infos
    wave = make_wave(seed)
    j = _decode(JaxSession, jinfo, wave)
    p = _decode(OnlineDecoderSession, pinfo, wave, splits=(4000, 9000))
    assert p.num_frames_decoded == j.num_frames_decoded > 50
    jb, pb = j.get_best_path(), p.get_best_path()
    assert pb["words"] == jb["words"]
    assert pb["cost"] == pytest.approx(jb["cost"], abs=1e-3)
    assert pb["reached_final"] == jb["reached_final"]


def test_nbest_matches_jax(infos):
    jinfo, pinfo = infos
    wave = make_wave(2, n=6000)
    j = _decode(JaxSession, jinfo, wave)
    p = _decode(OnlineDecoderSession, pinfo, wave)
    assert p.get_nbest_txt(3) == j.get_nbest_txt(3)


def test_subsampled_session_matches_jax():
    """Frame subsampling (skip=2 drops frames; skip_copy walks them)."""
    for am in (dict(skip=2), dict(skip=2, skip_copy=True)):
        from asr_decoder_tpu.models.nnet import AmConfig as JaxAmConfig
        jinfo = make_info(am_config=JaxAmConfig(**am), chunk_frames=18)
        pinfo = port_info(jinfo)
        wave = make_wave(9)
        j = _decode(JaxSession, jinfo, wave)
        p = _decode(OnlineDecoderSession, pinfo, wave, splits=(5000,))
        assert p.num_frames_decoded == j.num_frames_decoded
        assert p.get_best_path()["words"] == j.get_best_path()["words"]


def test_stream_vs_offline(infos):
    _, pinfo = infos
    wave = make_wave(1)
    ref = _decode(OnlineDecoderSession, pinfo, wave).get_best_path()
    for splits in ([160, 2500, 10000, 15555], [16000]):
        got = _decode(OnlineDecoderSession, pinfo, wave, splits)
        assert got.get_best_path() == ref


def _feed_interleaved(eng, cids, waves, chunks):
    cursors = [0] * len(cids)
    while any(c < len(w) for c, w in zip(cursors, waves)):
        for i, cid in enumerate(cids):
            if cursors[i] >= len(waves[i]):
                continue
            end = cursors[i] + chunks[i] >= len(waves[i])
            eng.push(cid, waves[i][cursors[i]:cursors[i] + chunks[i]],
                     eos=end)
            cursors[i] += chunks[i]
        eng.step()
    eng.drain()


def test_batched_matches_sessions_interleaved(infos):
    _, pinfo = infos
    waves = [make_wave(s, n=[16000, 9000, 12345][s]) for s in range(3)]
    want = [_decode(OnlineDecoderSession, pinfo, w).get_best_path()
            for w in waves]
    eng = BatchedStreamingDecoder(pinfo, num_channels=4)
    cids = [eng.acquire() for _ in range(3)]
    _feed_interleaved(eng, cids, waves, [5000, 3000, 4000])
    for i, cid in enumerate(cids):
        got = eng.get_best_path(cid)
        assert got["words"] == want[i]["words"]
        assert got["cost"] == want[i]["cost"]


def test_slot_reuse_starts_clean(infos):
    """A slot released while its channel's last tick still has logs on the
    way, then acquired again, starts with no logs (the JAX arena hands the
    new channel the old channel's last logs: ROADMAP §3 "high")."""
    _, pinfo = infos
    eng = BatchedStreamingDecoder(pinfo, num_channels=2)
    cid = eng.acquire()
    eng.push(cid, make_wave(10, n=9000))
    assert eng.step() == [cid]            # its logs are now pending
    eng.release(cid)
    cid2 = eng.acquire()
    assert cid2 == cid
    snap = eng.snapshot(cid2)
    assert snap.chunk_logs == [] and snap.frames_decoded == 0
    # and the reused slot decodes like a fresh session
    wave = make_wave(11, n=9000)
    eng.push(cid2, wave, eos=True)
    eng.drain()
    want = _decode(OnlineDecoderSession, pinfo, wave).get_best_path()
    assert eng.get_best_path(cid2) == want


def test_idle_channel_untouched(infos):
    _, pinfo = infos
    eng = BatchedStreamingDecoder(pinfo, num_channels=3)
    idle, busy = eng.acquire(), eng.acquire()
    before = eng.snapshot(idle).beam
    eng.push(busy, make_wave(12, n=8000), eos=True)
    eng.drain()
    after = eng.snapshot(idle).beam
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b, a)
    assert eng.get_best_path(idle)["words"] == []


def test_server_answers_concurrent_clients(infos):
    """Four concurrent streaming clients (the shared JAX-package client)
    each get a final reply whose words equal the port's batcher."""
    _, pinfo = infos
    waves = [make_wave(20 + s, n=[8000, 12000, 9000, 16000][s])
             for s in range(4)]
    eng = BatchedStreamingDecoder(pinfo, num_channels=4)
    cids = [eng.acquire() for _ in waves]
    _feed_interleaved(eng, cids, waves, [3200] * 4)
    want = [eng.get_best_path(c)["words"] for c in cids]

    async def run():
        server = AsrServer(pinfo, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    return await c.decode_utterance(w.astype(np.int16))
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w) for w in waves)), server
        finally:
            await server.stop()

    replies, server = asyncio.run(run())
    for r, w in zip(replies, want):
        assert r.end_flag == EndFlag.END
        assert r.results[0].words == w
    assert server.dispatches > 0
    assert server.total.wav_seconds == pytest.approx(
        sum(len(w) for w in waves) / 16000)


def test_unported_configs_raise(infos):
    jinfo, _ = infos
    for kw in (dict(graph_type="clg"), dict(use_energy_vad=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            OnlineDecoderInfo(
                from_numpy_layers([]), jinfo.fst, jinfo.words,
                jinfo.ilabel2pdf, online_config=OnlineDecoderConfig(**kw),
                device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port, its ``tools/perf`` included (and
    the shared host modules it uses), leaves jax out of the process."""
    code = (
        "import sys, pkgutil, importlib, asr_decoder_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'asr_decoder_tpu_torch.serving.server' in mods\n"
        "assert 'asr_decoder_tpu_torch.tools.perf.bench_points' in mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
