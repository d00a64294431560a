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


def _recorded(eng, monkeypatch):
    """``eng`` with each tick's logs delivered to host per-channel lists
    as the host-log arena delivers them (``_channel_rows`` of each advanced
    row's valid frames), next to its log store; ``init_decoding`` and
    ``release`` clear a channel's list.  Returns the lists by cid."""
    from asr_decoder_tpu_torch.serving.batcher import _channel_rows
    from asr_decoder_tpu_torch.serving.session import host_log
    search, C = eng.info.search, eng.info.config.chunk_frames
    logs = {c: [] for c in range(eng.B)}
    seen = []
    advance, step = search.advance, eng.step
    init_decoding, release = eng.init_decoding, eng.release

    def advance_kept(*a, **k):
        beam, log = advance(*a, **k)
        seen.append(host_log(log))
        return beam, log

    def step_kept():
        frames = {c: min(C, eng._channels[c].pending_frames)
                  for c in range(eng.B) if eng.ready(c)}
        seen.clear()
        advanced = step()
        for c in advanced:
            logs[c].append(type(seen[0])(*(_channel_rows(a, c, frames[c])
                                           for a in seen[0])))
        return advanced

    def cleared(fn):
        def call(cid):
            logs[cid] = []
            return fn(cid)
        return call
    monkeypatch.setattr(search, "advance", advance_kept)
    eng.step = step_kept
    eng.init_decoding = cleared(init_decoding)
    eng.release = cleared(release)
    return logs


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


@pytest.mark.parametrize("kind", ["hclg", "hclg-skip2"])
def test_store_walk_equals_the_host_walk(kind, monkeypatch):
    """One arena of 4 channels over rounds as the server runs them (push
    one chunk a live channel, tick while any is ready, then the round's
    beams copied and paths walked at once): streams of different lengths
    starting at different rounds, one acquired mid-run, one restarted by
    ``init_decoding`` mid-stream, one released at its end and its slot
    acquired again, and the log store's pool grown from its first 4 pages
    of 4 frames.  Every reply's path equals ``_walk_v3`` over the logs the
    host-log arena would have delivered, arc for arc, with its cost's bits
    and ``reached_final``; the logs copied out of the store equal those
    logs; each live channel holds the pages of its frames and no more."""
    from asr_decoder_tpu_torch.serving import logstore
    from asr_decoder_tpu_torch.serving.session import best_path, merge_logs
    monkeypatch.setattr(logstore, "PAGE_FRAMES", 4)
    _, pinfo = _infos(kind)
    eng = BatchedStreamingDecoder(pinfo, num_channels=4)
    assert eng._stored
    logs = _recorded(eng, monkeypatch)
    # (wave seed, samples, round it starts at)
    plan = [(70, 9000, 0), (71, 12000, 0), (72, 5000, 2), (73, 7000, 3),
            (74, 6000, 8)]
    step = 1600
    live, cursor, done, replies, used = {}, {}, set(), 0, []
    for rnd in range(40):
        for i, (seed, n, start) in enumerate(plan):
            if rnd == start:
                live[i] = eng.acquire()
                cursor[i] = 0
                used.append(live[i])
        if not live:
            break
        pushed = []
        for i, cid in list(live.items()):
            seed, n, _ = plan[i]
            wave = make_wave(seed, n=n)
            lo = cursor[i]
            eos = lo + step >= n
            eng.push(cid, wave[lo:lo + step], eos=eos)
            cursor[i] += step
            pushed.append((i, cid, eos))
        while eng.pending_work():
            eng.step()
        cids = [cid for _, cid, _ in pushed]
        beams, paths = eng.copy_beams(cids), eng.walk_paths(cids)
        for (i, cid, eos), beam, path in zip(pushed, beams, paths):
            snap = eng.snapshot(cid, beam, path, logs=True)
            got = eng.get_best_path_from(snap)
            want = best_path(pinfo, snap.beam, eng._init_log, logs[cid])
            assert got == want, (rnd, i)
            assert _bits(got["cost"]) == _bits(want["cost"])
            assert snap.frames_decoded == sum(len(c.prev_slot)
                                              for c in logs[cid])
            if logs[cid]:
                for a, b in zip(merge_logs(snap.chunk_logs),
                                merge_logs(logs[cid])):
                    np.testing.assert_array_equal(a, b)
            else:
                assert snap.chunk_logs == []
            replies += 1
            store, row = eng._blocks[0].store, cid
            assert store.held[row] == -(-(snap.frames_decoded + eng._channels[
                cid].pending_frames) // 4)
            if eos:
                eng.release(cid)
                del live[i]
                done.add(i)
            elif i == 1 and rnd == 4:
                eng.init_decoding(cid)      # an endpoint's restart
    assert done == set(range(len(plan))) and replies > 20
    assert len(set(used)) < len(used)                  # a slot reused
    assert eng._blocks[0].store.num_pages > 4          # the pool grew
    store = eng._blocks[0].store                       # all pages back
    assert not store.held.any() and len(store.free) == store.num_pages


def test_a_full_log_store_refuses_one_channel_and_keeps_the_others(
        monkeypatch):
    """A store whose limit is 6 pages of 32 frames, two channels: one
    streams on until a push needs a page past the limit, and that push
    raises ``LogStoreFull`` naming the limit, leaves the store as it was
    and closes the channel for input.  Releasing the refused channel
    returns its pages; the other channel goes on, and its path equals
    that of an arena with room."""
    from asr_decoder_tpu_torch.serving import logstore
    _, pinfo = _infos("hclg")
    K, S = pinfo.search.beam_width, pinfo.search.num_stages
    roomy = BatchedStreamingDecoder(pinfo, num_channels=2)
    monkeypatch.setattr(logstore, "CPU_BYTES", 6 * 32 * (2 * S + 2) * K * 4)
    eng = BatchedStreamingDecoder(pinfo, num_channels=2)
    long_, short = eng.acquire(), eng.acquire()
    other = roomy.acquire()
    wave = make_wave(90, n=6000)

    def feed_short(lo):
        for e, c in ((eng, short), (roomy, other)):
            e.push(c, wave[lo:lo + 2000], eos=lo + 2000 >= 6000)
            e.drain()
    feed_short(0)
    store = eng._blocks[0].store
    long_wave = make_wave(91, n=160000)
    with pytest.raises(logstore.LogStoreFull, match="limit"):
        for lo in range(0, len(long_wave), 4000):
            held = store.held.copy()
            eng.push(long_, long_wave[lo:lo + 4000])
            eng.drain()
    assert store.num_pages == 6 and np.array_equal(store.held, held)
    with pytest.raises(ValueError, match="not open"):
        eng.push(long_, long_wave[:4000])
    assert eng.get_best_path(long_)["arc_ids"]
    eng.release(long_)
    assert store.held[long_] == 0
    assert len(store.free) == store.num_pages - store.held[short]
    feed_short(2000)
    feed_short(4000)
    assert eng.get_best_path(short) == roomy.get_best_path(other)


def test_a_tick_sends_no_logs_to_the_host(monkeypatch):
    """A tick of one advancing channel among four: none of the logs the
    search returned and not the whole block's loglikes go to the host;
    the host gets that channel's loglikes alone, and its results are
    those of the arena's walk."""
    import torch
    _, pinfo = _infos("hclg")
    eng = BatchedStreamingDecoder(pinfo, num_channels=4)
    cids = [eng.acquire() for _ in range(4)]
    eng.push(cids[2], make_wave(80, n=6000))
    out, sent = {}, []
    advance, score = pinfo.search.advance, pinfo.score
    to = torch.Tensor.to

    def advance_seen(*a, **k):
        beam, log = advance(*a, **k)
        out["log"] = list(log)
        return beam, log

    def score_seen(*a, **k):
        ll, *rest = score(*a, **k)
        out["ll"] = ll
        return (ll, *rest)

    def to_seen(t, *a, **k):
        dev = k.get("device", a[0] if a else None)
        if isinstance(dev, (str, torch.device)) \
                and torch.device(dev).type == "cpu":
            sent.append(t)
        return to(t, *a, **k)
    monkeypatch.setattr(pinfo.search, "advance", advance_seen)
    monkeypatch.setattr(pinfo, "score", score_seen)
    monkeypatch.setattr(torch.Tensor, "to", to_seen)
    assert eng.step() == [cids[2]]
    monkeypatch.setattr(torch.Tensor, "to", to)
    held = [out["ll"], *out["log"]]
    assert not [t for t in sent if any(t is h for h in held)]
    assert [tuple(t.shape) for t in sent if t.dim() == 3
            and t.shape[-1] == out["ll"].shape[-1]] == [
        (1, *out["ll"].shape[1:])]
    snap = eng.snapshot(cids[2])
    assert snap.frames_decoded and len(snap.loglikes) == 1
    np.testing.assert_array_equal(
        snap.loglikes[0], out["ll"][2, :snap.frames_decoded].numpy())


@pytest.mark.parametrize("kind,where", [("hclg", "path/card"),
                                        ("clg", "path/host"),
                                        ("biglm-hclg", "path/host")])
def test_each_reply_records_where_its_path_came_from(fed, kind, where):
    """``get_best_path_from`` records one span a reply: ``path/card`` where
    the snapshot carries the path the arena walked over its log store,
    ``path/host`` where the reply walks host logs; a lattice or n-best
    needs the snapshot to carry the logs."""
    import time
    from asr_decoder_tpu_torch.utils import profiling
    pinfo, _, (eng, cids, idle), _ = fed(kind)
    t0 = time.perf_counter()
    for cid in (*cids, idle):
        eng.get_best_path_from(eng.snapshot(cid))
    got = [s.name for s in profiling.spans(t0, time.perf_counter())
           if s.name.startswith("path/")]
    assert got == [where] * (len(cids) + 1)
    assert eng.get_best_path(idle) == dict(
        arc_ids=[], cost=0.0, words=[], ilabels=[], reached_final=False)
    if where == "path/card":
        assert eng.snapshot(cids[0]).chunk_logs == []
        with pytest.raises(ValueError, match="logs=True"):
            eng.get_lattice_from(eng.snapshot(cids[0]))
        lat = eng.get_lattice_from(eng.snapshot(cids[0], logs=True))
        assert lat.num_states == eng.get_lattice(cids[0]).num_states


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
