"""The device traceback of the v3 search (``asr_decoder_tpu_torch/ops/
traceback.py``): on the CPU its plain version against the host walk
(``TorchBeamSearch._walk_v3`` through ``traceback``) on random small
graphs, exactly — arc ids, costs and final flags; on a GPU the kernel of
``csrc/traceback.cu`` against the plain version, bit for bit, and
``TorchBeamSearch.traceback`` on device logs against the same call on host
copies of them.  Imports nothing of JAX."""

import numpy as np
import pytest
import torch

from asr_decoder_tpu_torch.decoder.config import DecoderConfig
from asr_decoder_tpu_torch.fst.device_fst import DeviceFst
from asr_decoder_tpu_torch.fst.fst import StdFst
from asr_decoder_tpu_torch.fst.synthetic import random_hclg
from asr_decoder_tpu_torch.ops import beamsearch as BS
from asr_decoder_tpu_torch.ops import traceback as TB

PDFS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _emitting_graph(rng, num_states=40):
    """No ε arc anywhere, the final state reached by emitting arcs: a
    closure-free graph (C = 0, one stage a frame)."""
    deg = rng.integers(1, 5, num_states)
    src = np.repeat(np.arange(num_states), deg)
    dst = rng.integers(0, num_states, len(src))
    dst[np.r_[0, np.cumsum(deg)[:-1]]] = np.minimum(
        np.arange(num_states) + 1, num_states - 1)
    return StdFst.from_arcs(
        num_states, 0, num_states - 1, src,
        rng.integers(1, PDFS, len(src)), rng.integers(0, 6, len(src)) *
        (rng.random(len(src)) < 0.3), rng.random(len(src)) * 2, dst)


def _search(kind, seed, device="cpu", K=16, num_states=300, **kw):
    rng = np.random.default_rng(seed)
    if kind == "closure":
        fst = random_hclg(rng, num_states=num_states, num_ilabels=PDFS - 1,
                          num_words=20, max_degree=6, eps_frac=0.2)
    else:
        fst = _emitting_graph(rng)
    cfg = DecoderConfig(beam=kw.pop("beam", 8.0), beam_width=K,
                        max_active=K, min_active=kw.pop("min_active", 2),
                        arc_lanes=8, eps_mode="closure", relax_impl="topk",
                        **kw)
    search = BS.TorchBeamSearch(DeviceFst.build(fst, arc_lanes=8),
                                np.arange(PDFS, dtype=np.int32), cfg,
                                device=device)
    assert search.num_stages == (2 if kind == "closure" else 1)
    return fst, search


def _loglikes(seed, B, T, scale=3.0):
    rng = np.random.default_rng([seed, 1])
    return (rng.standard_normal((B, T, PDFS)) * scale).astype(np.float32)


def _mask(B, T, seed):
    """Padded rows (each its own length, one of them empty) and two frames
    masked in every row."""
    rng = np.random.default_rng([seed, 2])
    lens = rng.integers(0, T + 1, B)
    lens[0] = T
    mask = np.arange(T)[None, :] < lens[:, None]
    if T > 4:
        mask[:, [1, T // 2]] = False
    return mask


def _plain(search, state, init_log, logs):
    """The plain version over one FrameLog, on the search's device."""
    dev = search.device
    tables = TB.walk_tables(search.dev, search.A, search.C, dev)
    return TB.best_paths(tables, state.tok_state, state.tok_cost,
                         logs.prev_slot, logs.arc_id, logs.tok_state,
                         init_log.prev_slot, init_log.arc_id,
                         init_log.tok_state)


def _dicts(paths):
    return [dict(arc_ids=a.tolist(), cost=c, reached_final=f)
            for a, c, f in TB.unpack(paths.cpu().numpy())]


CASES = [("closure", s) for s in range(4)] + \
        [("emitting", s) for s in range(3)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_plain_equals_host_walk(kind, seed):
    """Padded rows and whole-batch dead frames; rows that reach the final
    state and rows that do not (a short frame budget, a narrow beam)."""
    fst, search = _search(kind, seed)
    B, T = 6, 24
    ll = _loglikes(seed, B, T)
    state, init_log, logs = search.decode(ll, _mask(B, T, seed))
    want = search.traceback(state, init_log, logs)
    got = _dicts(_plain(search, state, init_log, logs))
    assert got == want
    assert all(isinstance(a, int) for r in got for a in r["arc_ids"])


def test_final_flags_both_ways():
    """Over the cases above, some rows reach the final state and some do
    not, so both branches of the final-slot choice are held."""
    flags = set()
    for kind, seed in CASES:
        _, search = _search(kind, seed)
        B, T = 6, 24
        st, il, lg = search.decode(_loglikes(seed, B, T), _mask(B, T, seed))
        flags |= {r["reached_final"] for r in
                  _dicts(_plain(search, st, il, lg))}
    assert flags == {True, False}


@pytest.mark.parametrize("kind", ["closure", "emitting"])
def test_no_frames(kind):
    """T = 0: the final slot of the initial beam and the init closure
    path alone."""
    _, search = _search(kind, 11)
    state, init_log, logs = search.decode(_loglikes(11, 3, 0))
    assert logs.prev_slot.shape[0] == 0
    assert _dicts(_plain(search, state, init_log, logs)) == \
        search.traceback(state, init_log, logs)


def test_chunks_concatenated_equal_one_shot():
    """The chunk list, concatenated as the device path does, gives the
    one-shot logs' paths."""
    fst, search = _search("closure", 5)
    ll = _loglikes(5, 3, 21)
    state, init_log, logs = search.decode(ll)
    st, il = search.init_state(3)
    chunks = []
    for lo, hi in ((0, 8), (8, 9), (9, 21)):
        st, lg = search.advance(st, ll[:, lo:hi])
        chunks.append(lg)
    joined = BS.FrameLog(*(torch.cat(x) for x in zip(*chunks)))
    want = search.traceback(state, init_log, logs)
    assert search.traceback(st, il, chunks) == want
    assert _dicts(_plain(search, st, il, joined)) == want


def test_ties_go_to_the_lowest_slot():
    """Equal costs on final and non-final tokens, NaN and -0.0: the final
    slot is np.argmin's among the final tokens, else among all."""
    _, search = _search("closure", 2)
    state, init_log, logs = search.decode(_loglikes(2, 4, 6))
    fin = search.dev.final_state
    tok_state = state.tok_state.clone()
    tok_cost = state.tok_cost.clone()
    tok_state[0, [3, 5, 9]] = fin                    # finals tie at 1.0
    tok_cost[0, [2, 3, 5, 9]] = torch.tensor([0.5, 1.0, 1.0, 2.0])
    tok_state[1] = torch.where(tok_state[1] == fin, 0, tok_state[1])
    tok_cost[1, [4, 7]] = torch.tensor([-0.0, 0.0])  # no final: -0 == +0
    tok_cost[1, :4] = 0.0
    tok_state[2] = torch.where(tok_state[2] == fin, 0, tok_state[2])
    tok_cost[2, [6, 8]] = float("nan")               # NaN first
    tables = TB.walk_tables(search.dev, search.A, search.C, "cpu")
    slot, reached = TB._final_slots(fin, tok_state, tok_cost)
    for b in range(4):
        finals = np.where(tok_state[b].numpy() == fin)[0]
        c = tok_cost[b].numpy()
        want = (finals[np.argmin(c[finals])] if len(finals)
                else np.argmin(c))
        assert int(slot[b]) == int(want), b
        assert bool(reached[b]) == bool(len(finals)), b
    out = TB.best_paths(tables, tok_state, tok_cost, logs.prev_slot,
                        logs.arc_id, logs.tok_state, init_log.prev_slot,
                        init_log.arc_id, init_log.tok_state)
    assert out[0, TB.COST].view(torch.float32) == 1.0
    assert out[0, TB.FINAL] == 1 and out[1, TB.FINAL] == 0


def test_bad_logs_give_no_path():
    """A closure entry above a carried token, and a slot outside the beam:
    the row's length is -1 and ``unpack`` raises, as the host walk's
    assertion does."""
    _, search = _search("closure", 3)
    B, T = 3, 10
    state, init_log, logs = search.decode(_loglikes(3, B, T))
    prev, aid = logs.prev_slot.clone(), logs.arc_id.clone()
    out = _plain(search, state, init_log, logs)
    slot0 = TB._final_slots(search.dev.final_state, state.tok_state,
                            state.tok_cost)[0]
    aid[T - 1, 1, 0, slot0[0]] = 0                   # closure entry ...
    s0 = int(prev[T - 1, 1, 0, slot0[0]])
    aid[T - 1, 0, 0, s0] = BS.ARC_STAY               # ... above a stay
    prev[T - 1, 1, 1, slot0[1]] = search.beam_width  # outside the beam
    bad = _plain(search, state, init_log, BS.FrameLog(prev, aid,
                                                      *logs[2:]))
    assert bad[0, TB.LENGTH] == -1 and bad[1, TB.LENGTH] == -1
    assert torch.equal(bad[2], out[2])
    with pytest.raises(AssertionError):
        list(TB.unpack(bad.numpy()))


def test_cpu_never_launches():
    _, search = _search("closure", 1)
    before = TB.launches
    st, il, lg = search.decode(_loglikes(1, 2, 5))
    search.traceback(st, il, lg)
    _plain(search, st, il, lg)
    assert TB.launches == before


def test_bad_shapes_raise():
    _, search = _search("closure", 1)
    st, il, lg = search.decode(_loglikes(1, 2, 5))
    tables = TB.walk_tables(search.dev, search.A, search.C, "cpu")
    with pytest.raises(ValueError):
        TB.best_paths(tables, st.tok_state, st.tok_cost, lg.prev_slot[:, :1],
                      lg.arc_id[:, :1], lg.tok_state, il.prev_slot,
                      il.arc_id, il.tok_state)
    with pytest.raises(TypeError):
        TB.best_paths(tables, st.tok_state, st.tok_cost.double(),
                      lg.prev_slot, lg.arc_id, lg.tok_state, il.prev_slot,
                      il.arc_id, il.tok_state)


# ---- on the card ----------------------------------------------------------

def _kernel_vs_plain(search, state, init_log, logs):
    """The kernel and the plain version on the same device logs: every
    row's header and arcs bit for bit."""
    tables = TB.walk_tables(search.dev, search.A, search.C, search.device)
    args = (tables, state.tok_state, state.tok_cost, logs.prev_slot,
            logs.arc_id, logs.tok_state, init_log.prev_slot,
            init_log.arc_id, init_log.tok_state)
    before = TB.launches
    got = TB.best_paths(*args).cpu()
    assert TB.launches == before + 1
    want = TB.best_paths_plain(*args).cpu()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got[:, :TB.HEAD], want[:, :TB.HEAD])
    for g, w in zip(got, want):
        n = int(w[TB.LENGTH])
        assert torch.equal(g[:TB.HEAD + max(n, 0)], w[:TB.HEAD + max(n, 0)])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,seed", CASES)
def test_kernel_matches_plain_small(cuda, kind, seed):
    _, search = _search(kind, seed, device=cuda)
    B, T = 6, 24
    out = search.decode(_loglikes(seed, B, T), _mask(B, T, seed))
    _kernel_vs_plain(search, *out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,T,beam,min_active", [(256, 512, 267, 14.0, 16),
                                                    (32, 4096, 264, 12.0,
                                                     200)])
def test_kernel_matches_plain_at_cell_shapes(cuda, B, K, T, beam,
                                             min_active):
    """The offline cells' shapes: B 256, K 512 and B 32, K 4,096, two
    stages a frame (closure), ~265 frames, padded rows."""
    _, search = _search("closure", K, device=cuda, K=K,
                        num_states=50_000, beam=beam, min_active=min_active)
    out = search.decode(_loglikes(K, B, T), _mask(B, T, K))
    paths = _kernel_vs_plain(search, *out)
    assert (paths[:, TB.LENGTH] > 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closure", "emitting"])
def test_traceback_on_card_equals_host_copies(cuda, kind):
    """``TorchBeamSearch.traceback`` on device logs (one FrameLog, and a
    chunk list) against the same call on host copies of them, words and
    labels included: one kernel launch a call, none for host logs."""
    fst, search = _search(kind, 7, device=cuda)
    B, T = 8, 30
    ll = _loglikes(7, B, T)
    mask = _mask(B, T, 7)
    state, init_log, logs = search.decode(ll, mask)

    def host(x):
        return type(x)(*(t.cpu() for t in x))
    want = search.traceback(host(state), host(init_log), host(logs), fst)
    before = TB.launches
    got = search.traceback(state, init_log, logs, fst)
    assert TB.launches == before + 1
    assert got == want
    st, il = search.init_state(B)
    chunks = []
    for lo, hi in ((0, 11), (11, 12), (12, T)):
        st, lg = search.advance(st, ll[:, lo:hi], mask[:, lo:hi])
        chunks.append(lg)
    assert search.traceback(st, il, chunks, fst) == want
    assert search.traceback(host(st), host(il), [host(c) for c in chunks],
                            fst) == want
    assert TB.launches == before + 2
