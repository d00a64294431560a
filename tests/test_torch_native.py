"""The port's native host paths (``asr_decoder_tpu_torch/native``) on the
CPU: the n-shortest library against the port's Python n-shortest and
against the JAX package's native one, its callers (the batcher, the
session, the post service) through either path, and the C++ streaming
client against the port's server.

Tolerance: none — both packages build the same C++ source, so their
native n-best are equal bit for bit; native and Python n-best give the
same words, ilabels and order, and costs within 1e-4 (the library sums in
float32, the Python path in float64), as ``tests/test_post_service.py``
holds the JAX pair.  ``g++`` is on the machines these tests run on: a
failed build fails the tests rather than skipping them.
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from asr_decoder_tpu.fst import native_nbest as jnat  # noqa: E402
from asr_decoder_tpu_torch.fst import native_nbest as pnat  # noqa: E402
from asr_decoder_tpu_torch.fst.lattice import Lattice  # noqa: E402
from asr_decoder_tpu_torch.fst.nbest import nshortest  # noqa: E402
from asr_decoder_tpu_torch.serving import native_client  # noqa: E402
from asr_decoder_tpu_torch.serving.batcher import \
    BatchedStreamingDecoder  # noqa: E402
from asr_decoder_tpu_torch.serving.client import AsyncAsrClient  # noqa: E402
from asr_decoder_tpu_torch.serving.server import (AsrServer,  # noqa: E402
                                                  SocketConfig)
from asr_decoder_tpu_torch.serving.session import \
    OnlineDecoderSession  # noqa: E402

from test_post_service import make_word_lattice  # noqa: E402
from test_session import make_info, make_wave  # noqa: E402
from test_torch_serving import port_info  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pinfo():
    return port_info(make_info())


def _python_nbest(lat, n):
    return [dict(words=[a.olabel for a in p.arcs if a.olabel != 0],
                 ilabels=p.ilabels, graph_cost=p.graph_cost,
                 am_cost=p.am_cost) for p in nshortest(lat, n)]


def _same(got, want, exact=False):
    assert [(r["words"], r["ilabels"]) for r in got] == \
        [(r["words"], r["ilabels"]) for r in want]
    for g, w in zip(got, want):
        for k in ("graph_cost", "am_cost"):
            assert g[k] == (w[k] if exact else pytest.approx(w[k], abs=1e-4))


@pytest.mark.parametrize("name", ["lattice_ops", "asr_client"])
def test_sources_are_the_jax_packages(name):
    """Each C++ source is the JAX package's, byte for byte."""
    port = ROOT / "asr_decoder_tpu_torch" / "native" / f"{name}.cc"
    assert port.read_bytes() == \
        (ROOT / "asr_decoder_tpu" / "native" / f"{name}.cc").read_bytes()


def test_library_builds_under_build_dir():
    """The library builds with ``g++`` into the checkout's ``build/``."""
    assert pnat.available()
    lib = Path(pnat._lib()._name)
    assert lib.parent == ROOT / "build" / "asr_decoder_tpu_torch" / "native"
    assert Path(native_client._build_lib()).parent == lib.parent


@pytest.mark.parametrize("n", [1, 3, 8, 10])
def test_native_nbest_matches_python_and_jax(n):
    """On seeded word lattices (and without the unique-words filter): the
    port's native n-best equals the port's Python n-shortest and the JAX
    package's native n-best."""
    assert jnat.available()
    for seed in range(6):
        data = make_word_lattice(seed).to_bytes()
        lat = Lattice.from_bytes(data)
        got = pnat.nshortest_bytes(data, n)
        _same(got, _python_nbest(lat, n))
        _same(got, jnat.nshortest_bytes(data, n), exact=True)
        assert pnat.nshortest_bytes(data, n, unique_words=False) == \
            jnat.nshortest_bytes(data, n, unique_words=False)


def test_native_nbest_rejects_malformed():
    with pytest.raises(ValueError):
        pnat.nshortest_bytes(b"\x01\x00\x00\x00" * 10, 3)
    with pytest.raises(ValueError):   # truncated header
        pnat.nshortest_bytes(b"", 3)


def test_callers_native_equals_python(pinfo, monkeypatch):
    """The batcher's and the session's n-best, and the post service's
    ranked results, through the native library and with it turned off
    (the Python n-shortest): the same words in the same order."""
    from asr_decoder_tpu_torch.lm.arpa import parse_arpa
    from asr_decoder_tpu_torch.serving.post_service import (
        MODE_ADD, ConstLmRescorer, PostRequest, PostServer)
    from test_lm import ARPA, ARPA2
    wave = make_wave(2, n=4000)
    post = PostServer(ConstLmRescorer(parse_arpa(ARPA2,
                                                 word2id=parse_arpa(ARPA)
                                                 .vocab)))
    lat_bytes = make_word_lattice(3).to_bytes()

    def run():
        eng = BatchedStreamingDecoder(pinfo, 2)
        cid = eng.acquire()
        eng.push(cid, wave, eos=True)
        eng.drain()
        s = OnlineDecoderSession(pinfo)
        s.process_data(wave, eos=True)
        res = post._process(PostRequest(MODE_ADD, 0.5, 4, False, lat_bytes))
        assert res.ok
        return (eng.get_nbest(cid, 4), s.get_nbest(4),
                [(r.words, r.graph_cost, r.am_cost) for r in res.results])

    native = run()
    monkeypatch.setattr(pnat, "_lib", lambda: None)
    python = run()
    for got, want in zip(native[:2], python[:2]):
        assert got and [r["words"] for r in got] == \
            [r["words"] for r in want]
        assert [r["text"] for r in got] == [r["text"] for r in want]
        for g, w in zip(got, want):
            assert g["graph_cost"] + g["am_cost"] == pytest.approx(
                w["graph_cost"] + w["am_cost"], abs=1e-3)
    assert [r["words"] for r in native[0]] == [r["words"] for r in native[1]]
    assert [r[0] for r in native[2]] == [r[0] for r in python[2]]
    for g, w in zip(native[2], python[2]):
        assert g[1:] == pytest.approx(w[1:], abs=1e-4)


def test_python_fallback_skips_serialization(pinfo, monkeypatch):
    """Without the native library ``nbest_from_lattice`` runs the Python
    n-shortest on the lattice itself: the lattice is never serialized, and
    the result equals the native one."""
    from asr_decoder_tpu_torch.serving.session import nbest_from_lattice
    lat = Lattice.from_bytes(make_word_lattice(5).to_bytes())
    native = nbest_from_lattice(pinfo, lat, 3)
    monkeypatch.setattr(pnat, "_lib", lambda: None)

    def refuse(self):
        raise AssertionError("the Python path serialized the lattice")
    monkeypatch.setattr(Lattice, "to_bytes", refuse)
    python = nbest_from_lattice(pinfo, lat, 3)
    assert python and [r["words"] for r in python] == \
        [r["words"] for r in native]


def test_native_client_end_to_end(pinfo):
    """``NativeAsrClient`` streams to the port's ``AsrServer``: its text and
    word alignment equal the Python client's and a port session's (the
    counterpart of ``tests/test_service.py::test_native_client_end_to_end``)."""
    from asr_decoder_tpu_torch.serving.native_client import NativeAsrClient
    wave = make_wave(3).astype(np.int16)
    s = OnlineDecoderSession(pinfo)
    s.process_data(wave.astype(np.float32), eos=True)
    want = s.get_best_path_txt()

    async def run():
        server = AsrServer(pinfo, SocketConfig(port=0, num_channels=4))
        host, port = await server.start()
        try:
            def native_work():
                with NativeAsrClient(host, port) as c:
                    text = c.decode_utterance(wave)
                with NativeAsrClient(host, port) as c:
                    t2, end = c.send_chunk(wave, eos=True, ali_info=True)
                    return text, t2, end, c.last_align
            got = await asyncio.to_thread(native_work)
            c = AsyncAsrClient(host, port)
            await c.connect()
            try:
                reply = await c.decode_utterance(wave, chunk_samples=4000,
                                                 ali_info=True)
            finally:
                await c.close()
            return got, reply
        finally:
            await server.stop()

    (text, t2, end, align), reply = asyncio.run(run())
    assert text == t2 == want == reply.one_best() and end == 2
    assert [w for w, _, _ in align] == [a[0] for a in reply.align]
    np.testing.assert_allclose([a[1:] for a in align],
                               [a[1:] for a in reply.align], atol=1e-3)
    assert [w for w, _, _ in align] == want.split()
