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
from asr_decoder_tpu_torch.frontend.pipeline import DeltaConfig  # noqa: E402
from asr_decoder_tpu_torch.frontend.pitch import (  # noqa: E402
    PitchConfig, ProcessPitchConfig)
from asr_decoder_tpu_torch.lm.device_lm import DeviceDiffLm  # noqa: E402
from asr_decoder_tpu_torch.models.nnet import (AmConfig,  # noqa: E402
                                               from_numpy_layers)
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.server import (AsrServer,  # noqa: E402
                                                  SocketConfig)
from asr_decoder_tpu_torch.serving.session import (  # noqa: E402
    OnlineDecoderConfig, OnlineDecoderInfo, OnlineDecoderSession,
    word_alignment)
from asr_decoder_tpu_torch.vad.energy import EnergyVadConfig  # noqa: E402

from test_session import make_info, make_wave  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402


def port_info(jinfo) -> OnlineDecoderInfo:
    """The port's info over the JAX info's model, graph and configs (VAD,
    pitch and deltas included), all carried across as arrays into the
    port's own classes (for ``clg`` the same ClgFst, for ``biglm-hclg`` a
    DeviceDiffLm over the same host LMs and scales)."""
    layers = [(l.kind, l.input_dim, l.output_dim, l.meta,
               {k: np.asarray(v) for k, v in l.params.items()})
              for l in jinfo.nnet.layers]
    kw = {}
    if jinfo.config.graph_type == "clg":
        kw["clg_graph"] = to_port(jinfo.search.g)
    elif jinfo.config.graph_type == "biglm-hclg":
        d = jinfo.search.difflm
        kw["difflm"] = DeviceDiffLm.build(to_port(d.lm1.fsa),
                                          to_port(d.lm2.fsa), d.lm1_scale,
                                          d.lm2_scale, device="cpu")
    for name, cls in (("pitch_config", PitchConfig),
                      ("process_pitch_config", ProcessPitchConfig),
                      ("delta_config", DeltaConfig)):
        cfg = getattr(jinfo, name)
        if cfg is not None:
            kw[name] = cls(**asdict(cfg))
    return OnlineDecoderInfo(
        from_numpy_layers(layers, device="cpu"), to_port(jinfo.fst),
        to_port(jinfo.words), jinfo.ilabel2pdf,
        decoder_config=to_port(jinfo.decoder_config),
        online_config=OnlineDecoderConfig(**asdict(jinfo.config)),
        fbank_config=FbankConfig(**asdict(jinfo.fbank_config)),
        am_config=AmConfig(**asdict(jinfo.am_config)),
        vad_config=EnergyVadConfig(**asdict(jinfo.vad_config)), device="cpu",
        **kw)


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
    """The energy VAD, once refused, now builds and endpoints as JAX's
    session does (speech, then silence past ``endpoint_sil_frames``); every
    graph type is ported, and one that lacks its graph is refused."""
    from test_session import make_info
    jinfo = make_info(use_energy_vad=True, endpoint_sil_frames=20,
                      min_endpoint_frames=10)
    pinfo = port_info(jinfo)
    rng = np.random.default_rng(4)
    wave = np.concatenate([(rng.standard_normal(8000) * 4000),
                           np.zeros(6400)]).astype(np.float32)
    got = []
    for s in (JaxSession(jinfo), OnlineDecoderSession(pinfo)):
        flags = []
        for lo in range(0, len(wave), 1600):
            s.process_data(wave[lo:lo + 1600])
            flags.append(s.endpoint_detected())
        got.append(flags)
    assert got[0] == got[1] and got[1][-1] and not got[1][0]
    for kw in (dict(graph_type="clg"), dict(graph_type="biglm-hclg"),
               dict(graph_type="hmm")):
        with pytest.raises(ValueError):
            OnlineDecoderInfo(
                from_numpy_layers([], device="cpu"), pinfo.fst, pinfo.words,
                pinfo.ilabel2pdf, online_config=OnlineDecoderConfig(**kw),
                device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port, its ``tools/perf`` and its own
    copies of the host modules included, leaves jax and every module of
    the JAX package ``asr_decoder_tpu`` out of the process."""
    code = (
        "import sys, pkgutil, importlib, asr_decoder_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'asr_decoder_tpu_torch.serving.server' in mods\n"
        "assert 'asr_decoder_tpu_torch.tools.perf.bench_points' in mods\n"
        "assert 'asr_decoder_tpu_torch.fst.device_fst' in mods\n"
        "for m in ('tools.bench', 'tools.eval', 'eval.harness', "
        "'decoder.gold', 'decoder.ref_parity', 'fst.tlg', 'fst.algorithms', "
        "'utils.timer', 'cli.arpa2fsa', 'cli.convert_graph', "
        "'cli.lat_compose', 'cli.lmrescale', '__main__'):\n"
        "    assert 'asr_decoder_tpu_torch.' + m in mods, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'asr_decoder_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the clg and biglm-hclg graph types ----------------------------------

def graph_infos(graph_type: str, lm_lanes: int = 1 << 20, **online_kw):
    """(JAX info, port info) of one graph type over ``make_info``'s AM and
    words: ``clg`` over ``tests/test_clg.py``'s composite (15 pdfs),
    ``biglm-hclg`` over ``make_info``'s graph with the difference of
    ``tests/test_lm.py``'s two ARPA LMs (scales 0.7 / 1.3); ``online_kw``
    sets more session flags."""
    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.lm.arpa import parse_arpa
    from asr_decoder_tpu.lm.device_lm import DeviceDiffLm as JaxDiffLm
    from asr_decoder_tpu.serving.session import OnlineDecoderConfig as JOC
    from asr_decoder_tpu.serving.session import OnlineDecoderInfo as JOI
    from test_clg import make_clg
    from test_lm import ARPA, ARPA2
    base = make_info()
    kw, fst = {}, base.fst
    if graph_type == "clg":
        kw["clg_graph"] = make_clg(11, num_pdfs=15)[1]
        fst = None
    else:
        fsa1 = parse_arpa(ARPA)
        fsa2 = parse_arpa(ARPA2, word2id=fsa1.vocab)
        kw["difflm"] = JaxDiffLm.build(fsa1, fsa2, 0.7, 1.3)
    jinfo = JOI(base.nnet, fst, base.words, base.ilabel2pdf,
                decoder_config=DecoderConfig(
                    beam=1e9, beam_width=64, arc_lanes=8, min_active=0,
                    lattice_beam=8.0, eps_mode="sweeps", lm_lanes=lm_lanes),
                online_config=JOC(graph_type=graph_type, chunk_frames=16,
                                  **online_kw),
                fbank_config=base.fbank_config, **kw)
    return jinfo, port_info(jinfo)


@pytest.fixture(scope="module", params=["clg", "biglm-hclg"])
def graph(request):
    return graph_infos(request.param)


@pytest.mark.parametrize("seed", [0, 4])
def test_graph_type_session_matches_jax(graph, seed):
    """Words and cost against the JAX session; chunk splits do not change
    the port's result."""
    jinfo, pinfo = graph
    wave = make_wave(seed, n=12000)
    jb = _decode(JaxSession, jinfo, wave).get_best_path()
    pb = _decode(OnlineDecoderSession, pinfo, wave).get_best_path()
    assert pb["words"] == jb["words"]
    assert pb["cost"] == pytest.approx(jb["cost"], abs=1e-3)
    assert pb["reached_final"] == jb["reached_final"]
    assert not pb.get("overflowed")
    for splits in ((3000, 7000), (160, 11000)):
        got = _decode(OnlineDecoderSession, pinfo, wave, splits)
        assert got.get_best_path() == pb


def test_graph_type_lattice_and_alignment(graph):
    """Lattice n-best follows the best path for both graph types; word
    alignment exists for biglm-hclg and raises for clg (no arc-labelled
    fst), as in the JAX session."""
    jinfo, pinfo = graph
    wave = make_wave(2, n=9000)
    p = _decode(OnlineDecoderSession, pinfo, wave)
    j = _decode(JaxSession, jinfo, wave)
    assert p.get_lattice() is not None
    assert p.get_nbest_txt(3) == j.get_nbest_txt(3)
    if pinfo.config.graph_type == "clg":
        with pytest.raises(RuntimeError, match="alignment"):
            p.get_word_alignment()
    else:
        assert p.get_word_alignment() == j.get_word_alignment()


def test_graph_type_batcher_matches_sessions(graph):
    """The arena (beam lanes and logs sliced by the generic rule) against
    the port's sessions, interleaved, with a slot released and reused."""
    _, pinfo = graph
    waves = [make_wave(30 + s, n=[9000, 6000, 7500][s]) for s in range(3)]
    want = [_decode(OnlineDecoderSession, pinfo, w).get_best_path()
            for w in waves]
    eng = BatchedStreamingDecoder(pinfo, num_channels=3)
    spare = eng.acquire()
    eng.push(spare, make_wave(40, n=6000))
    eng.step()
    eng.release(spare)
    cids = [eng.acquire() for _ in waves]
    _feed_interleaved(eng, cids, waves, [3000, 2000, 2500])
    for cid, w in zip(cids, want):
        assert eng.get_best_path(cid) == w


def _serve(info, waves, **client_kw):
    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    return await c.decode_utterance(w.astype(np.int16),
                                                    **client_kw)
                finally:
                    await c.close()
            return await asyncio.gather(*(one(w) for w in waves))
        finally:
            await server.stop()
    return asyncio.run(run())


def test_graph_type_server_replies(graph):
    """Served replies equal the batcher; a clg request with ali_info set
    answers with no alignment (and does not crash), a biglm-hclg one with
    its spans."""
    _, pinfo = graph
    waves = [make_wave(50 + s, n=[8000, 6400][s]) for s in range(2)]
    eng = BatchedStreamingDecoder(pinfo, num_channels=2)
    cids = [eng.acquire() for _ in waves]
    _feed_interleaved(eng, cids, waves, [3200, 3200])
    replies = _serve(pinfo, waves, ali_info=True)
    for r, cid in zip(replies, cids):
        assert r.end_flag == EndFlag.END and not r.warn
        assert r.results[0].words == eng.get_best_path(cid)["words"]
        if pinfo.config.graph_type == "clg":
            assert not r.ali_info and not r.align
        else:
            assert r.ali_info
            # spans ride the wire as f32 seconds
            want = word_alignment(pinfo, eng.get_best_path(cid))
            assert [a[0] for a in r.align] == [a[0] for a in want]
            np.testing.assert_allclose([a[1:] for a in r.align],
                                       [a[1:] for a in want], atol=1e-6)


def test_biglm_server_warns_on_lm_lane_overflow():
    """lm_lanes too small for the graph: word candidates are dropped, the
    traceback says ``overflowed`` and the reply carries ``warn``."""
    _, pinfo = graph_infos("biglm-hclg", lm_lanes=2)
    wave = make_wave(60, n=8000)
    assert _decode(OnlineDecoderSession, pinfo, wave).get_best_path()[
        "overflowed"]
    (reply,) = _serve(pinfo, [wave])
    assert reply.end_flag == EndFlag.END and reply.warn


def test_build_info_loads_clg_with_hmmfst_file(tmp_path):
    """``--graph-type=clg --hmmfst-file=...``: the CLI loader reads the CLG
    layer and the HMM bundle and serves like an info built in process."""
    from asr_decoder_tpu_torch.cli._model import (build_info,
                                                  register_info_flags)
    from asr_decoder_tpu_torch.fst.clg import write_hmm_bundle
    from asr_decoder_tpu_torch.utils.config import ConfigOptions
    _, pinfo = graph_infos("clg")
    g = pinfo.search.g
    paths = {n: str(tmp_path / n) for n in ("am", "clg", "hmm", "words")}
    pinfo.nnet.write_binary(paths["am"])
    g.clg.write_binary(paths["clg"])
    write_hmm_bundle(paths["hmm"], g.hmms)
    pinfo.words.write_text(paths["words"])
    opts = ConfigOptions()
    dec, online, fbank, am, extra = register_info_flags(opts)
    pos = opts.parse(["--graph-type=clg", f"--hmmfst-file={paths['hmm']}",
                      "--beam=1e9", "--beam-width=64", "--min-active=0",
                      "--chunk-frames=16", "--fbank.num-bins=16",
                      paths["am"], paths["clg"], paths["words"]])
    info = build_info(*pos, dec, online, fbank, am, extra, device="cpu")
    assert info.fst is None and info.search.g.offset == g.offset
    wave = make_wave(5, n=9000)
    assert _decode(OnlineDecoderSession, info, wave).get_best_path() == \
        _decode(OnlineDecoderSession, pinfo, wave).get_best_path()
    extra["hmmfst-file"] = ""
    with pytest.raises(ValueError, match="hmmfst-file"):
        build_info(*pos, dec, online, fbank, am, extra, device="cpu")


def test_asr_to_post_pipeline():
    """The port's two services end to end (``tests/test_post_service.py::
    test_asr_to_post_pipeline``): decode over TCP, forward the final
    reply's lattice to the port's post service, get the rescored n-best
    back, equal to the in-process composition."""
    from asr_decoder_tpu_torch.fst.lattice import Lattice
    from asr_decoder_tpu_torch.fst.nbest import nshortest
    from asr_decoder_tpu_torch.lm.arpa import parse_arpa
    from asr_decoder_tpu_torch.lm.compose import ComposeArpaLm, compose_lattice
    from asr_decoder_tpu_torch.serving.post_service import (
        MODE_ADD, ConstLmRescorer, PostConfig, PostServer,
        rescore_via_service)
    from test_lm import ARPA, ARPA2
    lm2 = parse_arpa(ARPA2, word2id=parse_arpa(ARPA).vocab)
    pinfo = port_info(make_info())
    wave = make_wave(9)

    async def run():
        asr = AsrServer(pinfo, SocketConfig(port=0, num_channels=2,
                                            advertise_rescore=True))
        post = PostServer(ConstLmRescorer(lm2), PostConfig(port=0))
        ah, ap = await asr.start()
        ph, pp = await post.start()
        try:
            client = AsyncAsrClient(ah, ap)
            await client.connect()
            reply = await client.decode_utterance(wave.astype(np.int16),
                                                  lattice=True)
            await client.close()
            assert reply.lattice and reply.do_rescore
            lat = Lattice.from_bytes(reply.lattice)
            resp = await rescore_via_service(lat, ph, pp, mode=MODE_ADD,
                                             lm_scale=0.5, nbest=2)
            return lat, resp
        finally:
            await asr.stop()
            await post.stop()

    lat, resp = asyncio.run(run())
    assert resp.ok and resp.results and lat.num_states
    want = nshortest(compose_lattice(lat, ComposeArpaLm(lm2, 0.5)), 1)[0]
    assert resp.results[0].words == \
        [a.olabel for a in want.arcs if a.olabel != 0]
