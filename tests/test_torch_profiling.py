"""The port's program spans (``asr_decoder_tpu_torch/utils/profiling.py``):
the recorder itself, and the spans the server, the arena, the traceback
and the graph runner record, on the CPU.

The served case runs one utterance (and a second, concurrent one) through
``AsrServer`` with the JAX package's client and checks each packet's
spans: every ``request`` has its device calls and its result build under
its own ``req`` and inside its interval, the device calls run on the
device thread, and each tick's phases nest inside the ``device/step``
that ran them."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu.fst.device_fst import DeviceFst  # noqa: E402
from asr_decoder_tpu.ops import beamsearch as J  # noqa: E402
from asr_decoder_tpu.serving.client import AsyncAsrClient  # noqa: E402
from asr_decoder_tpu_torch.fst.device_fst import \
    DeviceFst as PortDeviceFst  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch as P  # noqa: E402
from asr_decoder_tpu_torch.serving.server import (AsrServer,  # noqa: E402
                                                  SocketConfig)
from asr_decoder_tpu_torch.utils import profiling  # noqa: E402
from asr_decoder_tpu_torch.utils.cuda_graphs import GraphRunner  # noqa: E402

from test_beamsearch import random_decode_graph  # noqa: E402
from test_session import make_info, make_wave  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402
from test_torch_serving import port_info  # noqa: E402

DEVICE_CALLS = {"device/push", "device/ready", "device/endpoint_detected",
                "device/snapshot", "device/step", "device/acquire",
                "device/release", "device/init_decoding"}


def test_span_records_its_interval_request_and_parent():
    t0 = time.perf_counter()
    with profiling.span("test/outer", ("c", 1)) as outer:
        with profiling.span("test/inner") as inner:
            pass
        profiling.record("test/queued", outer.start, time.perf_counter())
    with profiling.span("test/alone"):
        pass
    t1 = time.perf_counter()
    got = {s.name: s for s in profiling.spans(t0, t1)
           if s.name.startswith("test/")}
    assert set(got) == {"test/outer", "test/inner", "test/queued",
                        "test/alone"}
    me = threading.get_ident()
    assert all(s.thread == me for s in got.values())
    assert got["test/outer"] == (
        "test/outer", me, outer.start, outer.end, ("c", 1), None)
    assert got["test/inner"][2:] == (inner.start, inner.end, ("c", 1),
                                     "test/outer")
    assert got["test/queued"].req == ("c", 1)
    assert got["test/queued"].parent == "test/outer"
    assert got["test/alone"].req is None and got["test/alone"].parent is None
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert outer.seconds == outer.end - outer.start
    # an interval that cuts a span leaves it out
    assert "test/outer" not in {s.name for s in
                                profiling.spans(inner.start, t1)}


def test_span_parents_follow_their_asyncio_task():
    """Spans of tasks that interleave on one thread keep their own parents
    and requests."""
    async def one(tag):
        with profiling.span("test/task", tag):
            await asyncio.sleep(0.01)
            with profiling.span("test/child"):
                await asyncio.sleep(0.01)

    async def both():
        await asyncio.gather(one("a"), one("b"))

    t0 = time.perf_counter()
    asyncio.run(both())
    got = [s for s in profiling.spans(t0, time.perf_counter())
           if s.name.startswith("test/")]
    children = [s for s in got if s.name == "test/child"]
    assert sorted(s.req for s in children) == ["a", "b"]
    assert all(s.parent == "test/task" for s in children)
    for c in children:
        task = next(s for s in got if s.name == "test/task"
                    and s.req == c.req)
        assert task.start <= c.start <= c.end <= task.end


def test_ring_evicts_at_capacity_and_counts():
    ring = profiling.SpanRing(capacity=4)
    for i in range(6):
        ring.add((f"s{i}", 0, float(i), i + 0.5, None, None))
    assert ring.evicted == 2
    assert [s.name for s in ring.spans()] == ["s2", "s3", "s4", "s5"]
    assert [s.name for s in ring.spans(3.0, 4.5)] == ["s3", "s4"]
    assert ring.lost(1.5) and not ring.lost(1.6)
    # the process-wide ring holds a 48-s flood: ~17 spans a push, 200
    # pushes a second
    assert profiling.SPAN_CAPACITY >= 48 * 200 * 17


def test_graph_runner_on_the_cpu_records_no_capture():
    buf = torch.zeros(4)

    def body(b):
        b.add_(1)
        return b
    runner = GraphRunner(body, buf, torch.device("cpu"))
    t0 = time.perf_counter()
    with torch.inference_mode():
        runner()
        runner()
    assert buf.tolist() == [2.0] * 4
    assert not [s for s in profiling.spans(t0, time.perf_counter())
                if s.name == "capture"]


def test_traceback_spans_lie_inside_it_and_keep_the_arcs():
    """``traceback/copy`` then ``traceback/walk``, both inside the call;
    the arc ids, words and costs are the JAX engine's."""
    rng = np.random.default_rng(5)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = dict(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
               min_active=0, lattice_beam=1e9, eps_mode="closure",
               relax_impl="topk")
    jax_s = J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=8), i2p,
                            DecoderConfig(**cfg))
    port = P.TorchBeamSearch(PortDeviceFst.build(to_port(fst), arc_lanes=8),
                             i2p, to_port(DecoderConfig(**cfg)),
                             device="cpu")
    ll = rng.standard_normal((3, 12, 9)).astype(np.float32) * 3
    out = port.decode(ll)
    t0 = time.perf_counter()
    got = port.traceback(*out, to_port(fst))
    t1 = time.perf_counter()
    assert got == jax_s.traceback(*jax_s.decode(ll), fst)
    assert any(r["arc_ids"] for r in got)
    sp = {s.name: s for s in profiling.spans(t0, t1)
          if s.name.startswith("traceback/")}
    assert set(sp) == {"traceback/copy", "traceback/walk"}
    assert sp["traceback/copy"].end <= sp["traceback/walk"].start


def test_served_packets_carry_their_spans():
    info = port_info(make_info())
    waves = [make_wave(31, n=9600), make_wave(32, n=6400)]

    async def run():
        server = AsrServer(info, SocketConfig(port=0, num_channels=2))
        host, port = await server.start()
        try:
            async def one(w):
                c = AsyncAsrClient(host, port)
                await c.connect()
                try:
                    return await c.decode_utterance(w.astype(np.int16),
                                                    chunk_samples=3200)
                finally:
                    await c.close()
            replies = await asyncio.gather(*(one(w) for w in waves))
            device = server._pool.submit(threading.get_ident).result()
            return replies, device, server
        finally:
            await server.stop()

    t0 = time.perf_counter()
    replies, device, server = asyncio.run(run())
    got = profiling.spans(t0, time.perf_counter())
    assert all(r.results for r in replies)
    requests = [s for s in got if s.name == "request"]
    assert len(requests) == 3 + 2          # 3 and 2 pushes of 3200 samples
    assert len({s.req for s in requests}) == len(requests)
    for rq in requests:
        mine = [s for s in got if s.req == rq.req and s is not rq]
        names = {s.name for s in mine}
        assert {"pump", "write", "device/queue", "device/push",
                "device/ready", "device/snapshot", "results/queue",
                "results/build", "result/traceback",
                "result/align"} <= names, names
        for s in mine:
            assert rq.start <= s.start <= s.end <= rq.end, s
            if s.name in DEVICE_CALLS or s.name == "device/queue":
                assert s.thread == device and s.parent is None
            if s.name in ("pump", "write", "admission"):
                assert s.parent == "request" and s.thread == rq.thread
            if s.name.startswith("result/"):
                assert s.parent == "results/build"
    for conn in {rq.req[0] for rq in requests}:
        ns = sorted(rq.req[1] for rq in requests if rq.req[0] == conn)
        first = {s.name for s in got if s.req == (conn, ns[0])}
        last = {s.name for s in got if s.req == (conn, ns[-1])}
        assert {"admission", "device/acquire"} <= first
        assert "device/release" in last
    assert sum(s.end - s.start for s in requests) == pytest.approx(
        server.total.work_seconds)
    steps = [s for s in got if s.name == "device/step"]
    ticks = [s for s in got if s.name.startswith("tick/")]
    assert steps and {s.name for s in ticks} == {
        "tick/pack", "tick/launch", "tick/wait", "tick/deliver"}
    for t in ticks:
        assert t.parent == "device/step" and t.thread == device
        assert any(st.start <= t.start <= t.end <= st.end for st in steps)
    assert not [s for s in got if s.name == "capture"]
