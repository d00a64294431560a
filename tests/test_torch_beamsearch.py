"""The port's v3 beam search (``asr_decoder_tpu_torch/ops/beamsearch.py``) on
the CPU against the JAX v3 engine (``TpuBeamSearch(relax_impl="topk")``) and
the host gold decoder.

Tolerance: none against JAX.  Every op of the search is an fp32 add or
compare, an exact gather, or a sort, so the same inputs must give the same
logs bit for bit — token states, costs, backpointers — and therefore the
same words, arc ids and costs; tie order included (integer weights and
loglikes make equal-cost candidates on purpose).  Against the gold decoder
(float64-free host Dijkstra with its own summation order) costs agree to
1e-3, as in ``tests/test_beamsearch.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu.decoder.gold import GoldDecoder  # noqa: E402
from asr_decoder_tpu.fst.device_fst import DeviceFst  # noqa: E402
from asr_decoder_tpu.ops import beamsearch as J  # noqa: E402
from asr_decoder_tpu_torch.fst.device_fst import \
    DeviceFst as PortDeviceFst  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch as P  # noqa: E402

from test_beamsearch import random_decode_graph  # noqa: E402
from test_torch_host_copies import assert_same, to_port  # noqa: E402


def _cfg(**kw):
    base = dict(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
                min_active=0, lattice_beam=1e9, eps_mode="closure",
                relax_impl="topk")
    base.update(kw)
    return DecoderConfig(**base)


def _engines(fst, i2p, cfg):
    jax_s = J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=cfg.arc_lanes),
                            i2p, cfg)
    port = P.TorchBeamSearch(
        PortDeviceFst.build(to_port(fst), arc_lanes=cfg.arc_lanes), i2p,
        to_port(cfg), device="cpu")
    assert jax_s.relax_impl == "topk" and jax_s.num_stages == port.num_stages
    return jax_s, port


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_run(jax_out, port_out):
    """(state, init_log, logs) of both engines, leaf by leaf, bit-exact."""
    for j, p in zip(jax_out, port_out):
        for jl, pl in zip(j, p):
            np.testing.assert_array_equal(_bits(jl), _bits(pl.numpy()))


def _decode_both(fst, i2p, cfg, ll, mask=None):
    jax_s, port = _engines(fst, i2p, cfg)
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


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decode_matches_jax_and_gold(seed):
    rng = np.random.default_rng(seed)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg()
    ll = rng.standard_normal((1, 15, 9)).astype(np.float32) * 3
    _, _, res = _decode_both(fst, i2p, cfg, ll)
    gold = GoldDecoder(fst, i2p, cfg).decode(ll[0])
    assert res[0]["reached_final"] == gold.reached_final
    assert res[0]["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res[0]["words"] == gold.words
        assert res[0]["ilabels"] == gold.ilabels


def test_batched_varlen_with_dead_frames():
    """Variable lengths plus frames masked for the whole batch (the
    dead-frame skip) — bit-exact with JAX, equal to gold per utterance."""
    rng = np.random.default_rng(42)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg()
    B, T = 4, 20
    lens = np.array([20, 13, 7, 17])
    ll = rng.standard_normal((B, T, 9)).astype(np.float32) * 3
    mask = np.arange(T)[None, :] < lens[:, None]
    mask[:, [3, 4, 11]] = False            # whole-batch dead frames
    _, _, res = _decode_both(fst, i2p, cfg, ll, mask)
    for b in range(B):
        gold = GoldDecoder(fst, i2p, cfg).decode(ll[b][mask[b]])
        assert res[b]["cost"] == pytest.approx(gold.cost, abs=1e-3), b
        if gold.reached_final:
            assert res[b]["words"] == gold.words, b


@pytest.mark.parametrize("F", [1, 2])
def test_ties_and_pruning_match_jax(F):
    """Integer weights and loglikes (many equal costs), a narrow beam and
    a small K so the K·F cut, min_active and the ε-first regrouping all
    bind: the port must pick the same tokens in the same slots as JAX."""
    rng = np.random.default_rng(5)
    fst = _integer_graph(5, num_states=40, max_deg=6)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(beam=3.0, beam_width=16, max_active=16, min_active=3,
               topk_overfetch=F)
    ll = rng.integers(-3, 1, (3, 18, 9)).astype(np.float32)
    _decode_both(fst, i2p, cfg, ll)


def test_streamed_chunks_equal_one_shot():
    """advance over chunks + traceback over the chunk list == one shot."""
    rng = np.random.default_rng(8)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    _, port = _engines(fst, i2p, _cfg())
    ll = rng.standard_normal((2, 21, 9)).astype(np.float32) * 3
    st, il, logs = port.decode(ll)
    want = port.traceback(st, il, logs, to_port(fst))
    st2, il2 = port.init_state(2)
    chunks = []
    for lo, hi in ((0, 8), (8, 9), (9, 21)):
        st2, lg = port.advance(st2, ll[:, lo:hi])
        chunks.append(lg)
    got = port.traceback(st2, il2, chunks, to_port(fst))
    assert got == want


def test_lattices_match_jax():
    rng = np.random.default_rng(5)
    fst = random_decode_graph(rng)
    i2p = np.arange(9, dtype=np.int32)
    cfg = _cfg(lattice_beam=8.0)
    ll = rng.standard_normal((1, 12, 9)).astype(np.float32) * 3
    jax_s, port = _engines(fst, i2p, cfg)
    _, jil, jlg = jax_s.decode(ll)
    _, pil, plg = port.decode(ll)
    jl = jax_s.get_lattices(jil, jlg, ll, fst)[0]
    pl = port.get_lattices(pil, plg, ll, to_port(fst))[0]
    assert sorted(pl.to_text().splitlines()) == \
        sorted(jl.to_text().splitlines())


def test_tlg_decode_matches_jax():
    """A composed TLG (trie lexicon ∘ n-gram LM, ``fst/tlg.py``): LM backoff
    ε-chains and CTC blanks through the closure stage.  Each package builds
    the graph with its own ``build_tlg``; the two are equal arc for arc,
    and the port decodes its own."""
    from asr_decoder_tpu.fst import tlg as JT
    from asr_decoder_tpu.lm import arpa as JA
    from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text
    from asr_decoder_tpu_torch.fst import tlg as PT
    from asr_decoder_tpu_torch.lm import arpa as PA
    text = synth_arpa_text(vocab_size=40, n_bigram=90, n_trigram=40,
                           n_4gram=15, seed=2)
    fsa, pfsa = JA.parse_arpa(text), PA.parse_arpa(text)
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
    fst, i2p = JT.build_tlg(lexicon, fsa, 6)
    pfst, pi2p = PT.build_tlg(lexicon, pfsa, 6)
    assert_same(fst, pfst)
    assert_same(i2p, pi2p)
    cfg = _cfg(beam=10.0, beam_width=128, max_active=128, min_active=4,
               arc_lanes=16)
    sc = rng.standard_normal((2, 24, 7)) * 3
    ll = (sc - np.log(np.exp(sc).sum(-1, keepdims=True))).astype(np.float32)
    i2p = np.asarray(i2p, np.int32)
    jax_s = J.TpuBeamSearch(DeviceFst.build(fst, arc_lanes=16), i2p, cfg)
    port = P.TorchBeamSearch(PortDeviceFst.build(pfst, arc_lanes=16),
                             np.asarray(pi2p, np.int32), to_port(cfg),
                             device="cpu")
    jo, po = jax_s.decode(ll), port.decode(ll)
    _assert_same_run(jo, po)
    res = port.traceback(*po, pfst)
    assert res == jax_s.traceback(*jo, fst)
    assert all(np.isfinite(r["cost"]) for r in res)


def _relax_both(dst, cost, **kw):
    j = J._relax_topk(jax.numpy.asarray(dst), jax.numpy.asarray(cost),
                      gather_impl="xla", **kw)
    p = P._relax_topk(torch.from_numpy(dst), torch.from_numpy(cost), **kw)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    return p


def test_relax_topk_clo_grouping_robust_to_huge_costs():
    """The ε-first regrouping puts every live CLO_BIT destination before
    every live unmarked one, whatever the cost magnitudes (the port of
    ``tests/test_beamsearch.py``'s regression case), and equals JAX."""
    CLO = P.CLO_BIT
    K = 8
    dst = np.array([[1 | CLO, 2, 3 | CLO, 4, 5, 6 | CLO,
                     7, 8, 9, 10, 11 | CLO, 12]], np.int32)
    cost = np.array([[9.9e8, 1.0, 5.0e8, 2.0, 3.0, 7.0e8,
                      4.0, 5.0, 6.0, 7.0, 8.8e8, 9.0]], np.float32)
    for F in (1, 2):
        state, cost2, fi, alive, live = _relax_both(
            dst, cost, K=K, beam=1e9, min_active=0, F=F, clo_first=True)
        state, alive = state.numpy()[0], alive.numpy()[0]
        bits = [(int(s) >> 30) & 1 if s >= 0 else -1 for s in state]
        nbit = sum(b == 1 for b in bits)
        first_unmarked = bits.index(0)
        assert all(b == 1 for b in bits[:first_unmarked][:nbit])
        assert all(b != 1 for b in bits[first_unmarked:] if b >= 0), bits
        if F == 1:
            assert int(live[0]) == K
        want = set(np.sort(cost[0])[:K].tolist())
        assert set(cost2.numpy()[0][alive].tolist()) == want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("clo_first", [False, True])
@pytest.mark.parametrize("F", [1, 2])
def test_relax_topk_ties_match_jax(seed, clo_first, F):
    """Duplicate destinations, equal costs, signed zeros and dead
    candidates: every output of the relax equals JAX's, slot for slot."""
    rng = np.random.default_rng(seed)
    B, N, K = 3, 48, 8
    dst = rng.integers(0, 12, (B, N)).astype(np.int32)
    dst |= np.where(rng.random((B, N)) < 0.4, P.CLO_BIT, 0).astype(np.int32)
    cost = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0, 3.0, np.inf],
                               np.float32), (B, N))
    dst = np.where(np.isinf(cost), P.BIG_STATE, dst).astype(np.int32)
    for beam, min_active in ((1e9, 0), (1.0, 3)):
        _relax_both(dst, cost, K=K, beam=beam, min_active=min_active, F=F,
                    clo_first=clo_first)


def test_unported_configs_raise():
    """The TPU implementation knobs have no meaning in the port: the
    tensor's device picks the kernel.  (The v2 and sweeps configs that
    raised here before they were ported are parity cases of
    ``tests/test_torch_beamsearch_v2.py``.)"""
    fst = random_decode_graph(np.random.default_rng(0))
    i2p = np.arange(9, dtype=np.int32)
    for kw in (dict(gather_impl="xla"), dict(fetch_impl="dma")):
        with pytest.raises(ValueError, match="device"):
            P.TorchBeamSearch(PortDeviceFst.build(to_port(fst), arc_lanes=8),
                              i2p, to_port(_cfg(**kw)), device="cpu")
