"""The port's v2 beam search (``relax_impl="sort"``, closure and sweeps ε
modes, ``asr_decoder_tpu_torch/ops/beamsearch.py``) on the CPU against the
JAX v2 engine (``TpuBeamSearch(relax_impl="sort")``), the host gold
decoder and the JAX session; and the ``auto`` engine selection against the
JAX class.

Tolerance: none against JAX.  Every op of the search is an fp32 add or
compare, an exact gather, or a sort, so the same inputs give the same logs
bit for bit, and the same words, arc ids and costs; tie order included
(integer weights, integer loglikes and signed zeros make equal costs on
purpose).  Against the gold decoder costs agree to 1e-3, as in
``tests/test_beamsearch.py``; against the JAX session (whose AM differs in
the last fp32 bits, ``tests/test_torch_models.py``) words are equal and
costs agree to 1e-3.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu.decoder.gold import GoldDecoder  # noqa: E402
from asr_decoder_tpu.fst.device_fst import DeviceFst  # noqa: E402
from asr_decoder_tpu.fst.fst import StdFst  # noqa: E402
from asr_decoder_tpu.ops import beamsearch as J  # noqa: E402
from asr_decoder_tpu_torch.fst.device_fst import \
    DeviceFst as PortDeviceFst  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch as P  # noqa: E402

from test_beamsearch import random_decode_graph  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402

MODES = ["closure", "sweeps"]


def _cfg(**kw):
    base = dict(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
                min_active=0, lattice_beam=1e9, eps_mode="closure",
                relax_impl="sort")
    base.update(kw)
    return DecoderConfig(**base)


def _engines(fst, i2p, cfg):
    jax_s = J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=cfg.arc_lanes),
                            i2p, cfg)
    port = P.TorchBeamSearch(
        PortDeviceFst.build(to_port(fst), arc_lanes=cfg.arc_lanes), i2p,
        to_port(cfg), device="cpu")
    assert (port.mode, port.relax_impl, port.num_stages) == \
        (jax_s.mode, jax_s.relax_impl, jax_s.num_stages)
    return jax_s, port


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_run(jax_out, port_out):
    """(state, init_log, logs) of both engines, leaf by leaf, bit-exact."""
    for j, p in zip(jax_out, port_out):
        for jl, pl in zip(j, p):
            assert np.asarray(jl).shape == tuple(pl.shape)
            np.testing.assert_array_equal(_bits(jl), _bits(pl.numpy()))


def _decode_both(fst, i2p, cfg, ll, mask=None):
    jax_s, port = _engines(fst, i2p, cfg)
    assert port.relax_impl == "sort"
    jo = jax_s.decode(ll, mask)
    po = port.decode(ll, mask)
    _assert_same_run(jo, po)
    jr = jax_s.traceback(*jo, fst)
    pr = port.traceback(*po, to_port(fst))
    assert pr == jr
    return port, po, pr


def _integer_graph(seed, **kw):
    """A random decode graph with integer weights: equal-cost paths."""
    fst = random_decode_graph(np.random.default_rng(seed), **kw)
    fst.arc_weight[:] = np.round(fst.arc_weight)
    return fst


# -- _relax_and_prune, slot for slot ----------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_extra", [0, 1, 2])
def test_relax_and_prune_matches_jax(seed, n_extra):
    """Duplicate destinations (and extra identity keys), equal costs,
    signed zeros and dead candidates: every output of the v2 relax —
    state, cost, winner, keep mask and the pruned extra keys — equals
    JAX's, slot for slot, with and without beam and min_active binding."""
    rng = np.random.default_rng(seed)
    B, N, K = 3, 48, 8
    dst = rng.integers(0, 10, (B, N)).astype(np.int32)
    cost = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0, 3.0, np.inf],
                               np.float32), (B, N))
    extra = [rng.integers(0, 3, (B, N)).astype(np.int32)
             for _ in range(n_extra)]
    for beam, min_active in ((1e9, 0), (1.0, 3), (0.5, 6)):
        kw = dict(K=K, beam=beam, min_active=min_active)
        j = J._relax_and_prune(jax.numpy.asarray(dst),
                               jax.numpy.asarray(cost), gather_impl="xla",
                               extra_keys=tuple(map(jax.numpy.asarray,
                                                    extra)), **kw)
        p = P._relax_and_prune(torch.from_numpy(dst), torch.from_numpy(cost),
                               extra_keys=tuple(map(torch.from_numpy, extra)),
                               **kw)
        assert len(j) == len(p) == 4 + n_extra
        for a, b in zip(j, p):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_relax_and_prune_min_active_after_dedup():
    """v2 counts ``min_active`` after the merge: with every candidate on
    one of three destinations and a zero beam, the three distinct states
    survive (v3 would count duplicates before its dedup)."""
    dst = torch.tensor([[5, 5, 5, 7, 7, 9, 9, 9]], dtype=torch.int32)
    cost = torch.tensor([[0.0, 0.1, 0.2, 3.0, 3.1, 6.0, 6.1, 6.2]])
    state, c, win, keep = P._relax_and_prune(dst, cost, K=4, beam=1e-3,
                                             min_active=3)
    assert state.tolist() == [[5, 7, 9, -1]]
    assert win.tolist() == [[0, 3, 5, 0]]
    assert keep.tolist() == [[True, True, True, False]]


# -- full decodes against JAX and the gold decoder ---------------------------

@pytest.mark.parametrize("eps_mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_matches_gold_single(seed, eps_mode):
    """The port of ``tests/test_beamsearch.py::test_device_matches_gold_
    single`` for the v2 engine — and bit-exact with JAX's v2."""
    rng = np.random.default_rng(seed)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(eps_mode=eps_mode)
    ll = rng.standard_normal((1, 15, 9)).astype(np.float32) * 3
    port, _, res = _decode_both(fst, i2p, cfg, ll)
    assert port.mode == eps_mode
    gold = GoldDecoder(fst, i2p, cfg).decode(ll[0])
    assert res[0]["reached_final"] == gold.reached_final
    assert res[0]["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res[0]["words"] == gold.words
        assert res[0]["ilabels"] == gold.ilabels


@pytest.mark.parametrize("eps_mode", MODES)
def test_device_matches_gold_batched_varlen(eps_mode):
    """Variable lengths plus whole-batch dead frames (the frame skip)."""
    rng = np.random.default_rng(42)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(eps_mode=eps_mode)
    B, T = 4, 20
    lens = np.array([20, 13, 7, 17])
    ll = rng.standard_normal((B, T, 9)).astype(np.float32) * 3
    mask = np.arange(T)[None, :] < lens[:, None]
    mask[:, [3, 11]] = False
    _, _, res = _decode_both(fst, i2p, cfg, ll, mask)
    for b in range(B):
        gold = GoldDecoder(fst, i2p, cfg).decode(ll[b][mask[b]])
        assert res[b]["cost"] == pytest.approx(gold.cost, abs=1e-3), b
        if gold.reached_final:
            assert res[b]["words"] == gold.words, b


@pytest.mark.parametrize("eps_mode", MODES)
def test_ties_and_pruning_match_jax(eps_mode):
    """Integer weights and loglikes, a narrow beam, a small K and
    min_active binding: the same tokens in the same slots as JAX."""
    rng = np.random.default_rng(5)
    fst = _integer_graph(5, num_states=40, max_deg=6)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(beam=3.0, beam_width=16, max_active=16, min_active=3,
               eps_mode=eps_mode)
    ll = rng.integers(-3, 1, (3, 18, 9)).astype(np.float32)
    _decode_both(fst, i2p, cfg, ll)


@pytest.mark.parametrize("eps_mode", MODES)
def test_streamed_chunks_equal_one_shot(eps_mode):
    """advance over chunks + traceback over the chunk list == one shot."""
    rng = np.random.default_rng(8)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    port = P.TorchBeamSearch(PortDeviceFst.build(to_port(fst), arc_lanes=8),
                             i2p, to_port(_cfg(eps_mode=eps_mode)),
                             device="cpu")
    ll = rng.standard_normal((2, 21, 9)).astype(np.float32) * 3
    want = port.traceback(*port.decode(ll), to_port(fst))
    st, il = port.init_state(2)
    chunks = []
    for lo, hi in ((0, 8), (8, 9), (9, 21)):
        st, lg = port.advance(st, ll[:, lo:hi])
        chunks.append(lg)
    assert port.traceback(st, il, chunks, to_port(fst)) == want


@pytest.mark.parametrize("eps_mode", MODES)
def test_lattices_match_jax(eps_mode):
    rng = np.random.default_rng(5)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(lattice_beam=8.0, eps_mode=eps_mode)
    ll = rng.standard_normal((2, 12, 9)).astype(np.float32) * 3
    jax_s, port = _engines(fst, i2p, cfg)
    _, jil, jlg = jax_s.decode(ll)
    _, pil, plg = port.decode(ll)
    for jl, pl in zip(jax_s.get_lattices(jil, jlg, ll, fst),
                      port.get_lattices(pil, plg, ll, to_port(fst))):
        assert sorted(pl.to_text().splitlines()) == \
            sorted(jl.to_text().splitlines())


@pytest.mark.parametrize("eps_mode", MODES)
def test_tlg_decode_matches_jax(eps_mode):
    """A composed TLG (trie lexicon ∘ n-gram LM): LM backoff ε-chains and
    CTC blanks through the closure stage or the ε sweeps."""
    from asr_decoder_tpu.fst.tlg import build_tlg
    from asr_decoder_tpu.lm.arpa import parse_arpa
    from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text
    fsa = parse_arpa(synth_arpa_text(vocab_size=40, n_bigram=90,
                                     n_trigram=40, n_4gram=15, seed=2))
    rng = np.random.default_rng(2)
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if wname.startswith("w"):
            ph = [int(rng.integers(1, 7))]
            while len(ph) < int(rng.integers(2, 5)):
                p = int(rng.integers(1, 7))
                if p != ph[-1]:
                    ph.append(p)
            lexicon[wid] = ph
    fst, i2p = build_tlg(lexicon, fsa, 6)
    cfg = _cfg(beam=10.0, beam_width=128, max_active=128, min_active=4,
               arc_lanes=16, eps_mode=eps_mode)
    sc = rng.standard_normal((2, 24, 7)) * 3
    ll = (sc - np.log(np.exp(sc).sum(-1, keepdims=True))).astype(np.float32)
    _, _, res = _decode_both(fst, np.asarray(i2p, np.int32), cfg, ll)
    assert all(np.isfinite(r["cost"]) for r in res)


def test_eps_free_graph_with_forced_sweeps():
    """``eps_iters`` forced on an ε-free graph: zero-lane ε table, every
    sweep is the ``L == 0`` stay-put branch — still JAX's logs and gold's
    path."""
    rng = np.random.default_rng(11)
    n = 30          # emitting arcs only, super-final state n-1 reached by one
    src = np.repeat(np.arange(n - 1), 3)
    dst = np.minimum(src + rng.integers(0, 3, len(src)), n - 1)
    fst = StdFst.from_arcs(n, 0, n - 1, src, rng.integers(1, 9, len(src)),
                           rng.integers(0, 5, len(src)),
                           rng.random(len(src)) * 2, dst)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(eps_mode="sweeps", eps_iters=2)
    ll = rng.standard_normal((2, 10, 9)).astype(np.float32) * 3
    port, (_, init_log, logs), res = _decode_both(fst, i2p, cfg, ll)
    assert port.graph.eps_rec.shape[1] == 0 and port.num_stages == 3
    assert (logs.arc_id[:, 1:] == P.ARC_STAY).all()
    for b in range(2):
        gold = GoldDecoder(fst, i2p, cfg).decode(ll[b])
        assert res[b]["cost"] == pytest.approx(gold.cost, abs=1e-3)


@pytest.mark.parametrize("eps_mode", MODES)
def test_no_snapshots_matches_jax(eps_mode):
    """``log_snapshots=False``: zero-width frame snapshots, the same best
    paths, and lattices refused as in JAX."""
    rng = np.random.default_rng(3)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(eps_mode=eps_mode, log_snapshots=False)
    ll = rng.standard_normal((2, 9, 9)).astype(np.float32) * 3
    port, (_, init_log, logs), _ = _decode_both(fst, i2p, cfg, ll)
    assert tuple(logs.tok_state.shape) == (9, 2, 0)
    with pytest.raises(RuntimeError, match="log_snapshots"):
        port.get_lattices(init_log, logs, ll, to_port(fst))


# -- the auto rules pick JAX's engine and mode ------------------------------

def _hub_graph(degree: int) -> StdFst:
    """State 0 has ``degree`` emitting arcs to a chain, one ε arc ahead."""
    src = [0] * degree + [i + 1 for i in range(degree)] + [0]
    dst = [i + 1 for i in range(degree)] + [degree + 1] * degree + [1]
    il = list(range(1, degree + 1)) + [1] * degree + [0]
    n = len(src)
    return StdFst.from_final_weights(
        degree + 2, 0, np.array(src), np.array(il), np.ones(n, np.int64),
        np.full(n, 0.5), np.array(dst), {degree + 1: 0.0})


def _eps_graph(weight: float, cycle: bool) -> StdFst:
    """0 -a-> 1 -ε-> 2 -b-> 3 (final), with an optional ε arc 2 → 1."""
    src, dst, il, w = [0, 1, 2], [1, 2, 3], [1, 0, 2], [1.0, weight, 1.0]
    if cycle:
        src, dst, il, w = src + [2], dst + [1], il + [0], w + [0.5]
    n = len(src)
    return StdFst.from_final_weights(
        4, 0, np.array(src), np.array(il), np.zeros(n, np.int64),
        np.array(w), np.array(dst), {3: 0.0})


@pytest.mark.parametrize("case,want", [
    ("default", ("closure", "topk")),
    ("no_snapshots", ("closure", "sort")),
    ("wide_closure", ("sweeps", "sort")),
    ("wide_record", ("closure", "sort")),
    ("negative_eps", ("sweeps", "sort")),
    ("eps_cycle", ("closure", "topk")),
])
def test_auto_selection_matches_jax(case, want):
    i2p = None
    kw = dict(eps_mode="auto", relax_impl="auto")
    if case == "wide_record":
        fst, kw["arc_lanes"] = _hub_graph(44), 48      # 3A = 132 > 128
        i2p = np.arange(45, dtype=np.int32)
    elif case in ("negative_eps", "eps_cycle"):
        fst = _eps_graph(-0.5 if case == "negative_eps" else 0.5,
                         cycle=case == "eps_cycle")
    else:
        fst = random_decode_graph(np.random.default_rng(1))
        if case == "no_snapshots":
            kw["log_snapshots"] = False
        elif case == "wide_closure":
            kw["closure_lanes_max"] = 0
    cfg = _cfg(**kw)
    i2p = i2p if i2p is not None else np.arange(9, dtype=np.int32)
    jax_s, port = _engines(fst, i2p, cfg)
    assert (port.mode, port.relax_impl) == want
    ll = np.random.default_rng(0).standard_normal(
        (1, 6, len(i2p))).astype(np.float32)
    jo, po = jax_s.decode(ll), port.decode(ll)
    _assert_same_run(jo, po)
    assert port.traceback(*po, to_port(fst)) == jax_s.traceback(*jo, fst)


def test_selection_refusals_match_jax():
    """Where JAX refuses a config, the port refuses it too: sweeps on an ε
    cycle, closure on negative ε weights, topk where v3 cannot run."""
    i2p = np.arange(9, dtype=np.int32)
    cases = [(_eps_graph(0.5, cycle=True), dict(eps_mode="sweeps")),
             (_eps_graph(-0.5, cycle=False), dict(eps_mode="closure")),
             (random_decode_graph(np.random.default_rng(1)),
              dict(eps_mode="sweeps", relax_impl="topk")),
             (random_decode_graph(np.random.default_rng(1)),
              dict(log_snapshots=False, relax_impl="topk"))]
    for fst, kw in cases:
        with pytest.raises((AssertionError, ValueError)):
            J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=8), i2p,
                            _cfg(**kw))
        with pytest.raises(ValueError):
            P.TorchBeamSearch(PortDeviceFst.build(to_port(fst), arc_lanes=8),
                              i2p, to_port(_cfg(**kw)), device="cpu")


# -- the session in sweeps mode ---------------------------------------------

def test_sweeps_session_matches_jax_session():
    """The port's ``OnlineDecoderInfo`` with ``eps_mode="sweeps"`` on an
    hclg graph gives the JAX session's words, costs and n-best."""
    from asr_decoder_tpu.fst.symbol import SymbolTable
    from asr_decoder_tpu.models.flagship import make_flagship
    from asr_decoder_tpu.serving.session import (OnlineDecoderConfig,
                                                 OnlineDecoderInfo,
                                                 OnlineDecoderSession)
    from asr_decoder_tpu.frontend.fbank import FbankConfig
    from asr_decoder_tpu_torch.serving.session import \
        OnlineDecoderSession as PortSession
    from test_session import make_wave
    from test_torch_serving import port_info
    rng = np.random.default_rng(4)
    fst = random_decode_graph(rng, num_states=40, num_labels=15)
    words = SymbolTable()
    words.add("<eps>", 0)
    for i in range(1, 6):
        words.add(f"w{i}", i)
    jinfo = OnlineDecoderInfo(
        make_flagship(jax.random.PRNGKey(4), feat_dim=16, num_pdfs=16,
                      hidden=16, proj=8, num_layers=1, context=1),
        fst, words, np.arange(16, dtype=np.int32),
        decoder_config=DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8,
                                     min_active=0, lattice_beam=8.0,
                                     eps_mode="sweeps"),
        online_config=OnlineDecoderConfig(chunk_frames=16),
        fbank_config=FbankConfig(num_bins=16))
    pinfo = port_info(jinfo)
    assert (pinfo.search.mode, pinfo.search.relax_impl) == ("sweeps", "sort")
    wave = make_wave(4)
    j = OnlineDecoderSession(jinfo)
    j.process_data(wave, eos=True)
    p = PortSession(pinfo)
    for lo, hi in ((0, 4000), (4000, 9000), (9000, len(wave))):
        p.process_data(wave[lo:hi], eos=hi == len(wave))
    assert p.num_frames_decoded == j.num_frames_decoded > 50
    jb, pb = j.get_best_path(), p.get_best_path()
    assert pb["words"] == jb["words"]
    assert pb["cost"] == pytest.approx(jb["cost"], abs=1e-3)
    assert p.get_nbest_txt(3) == j.get_nbest_txt(3)
