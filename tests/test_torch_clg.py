"""The port's CLG-on-the-fly search (``asr_decoder_tpu_torch/ops/
beamsearch_clg.py``) on the CPU against the JAX ``TpuClgBeamSearch`` and the
host ``GoldClgDecoder``.

Tolerance: none against JAX.  Every op of the search is an int32 index
computation, an fp32 add or compare, an exact gather or a sort, so the
same inputs give the same graph arrays, stage outputs, logs, tracebacks
and lattices, bit for bit.  Against the gold decoder costs agree to 1e-3,
as in ``tests/test_clg.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.config import DecoderConfig  # noqa: E402
from asr_decoder_tpu.decoder.gold import GoldClgDecoder  # noqa: E402
from asr_decoder_tpu.ops import beamsearch_clg as J  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch_clg as P  # noqa: E402

from test_clg import make_clg  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402

I2P = np.arange(7, dtype=np.int32)


def _cfg(**kw):
    return DecoderConfig(**{**dict(beam=1e9, beam_width=64, arc_lanes=8,
                                   max_active=64, min_active=0,
                                   lattice_beam=6.0, eps_mode="sweeps"),
                            **kw})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(jax_tree, port_tree):
    for j, p in zip(jax_tree, port_tree):
        if isinstance(p, torch.Tensor):
            assert np.asarray(j).shape == tuple(p.shape)
            np.testing.assert_array_equal(_bits(j), _bits(p.numpy()))
        else:
            _assert_same(j, p)


@pytest.mark.parametrize("seed", [0, 1, 2, 11])
def test_graph_arrays_match_jax(seed):
    _, g = make_clg(seed)
    jg, jil = J.make_clg_graph_arrays(g, I2P)
    pg, pil = P.make_clg_graph_arrays(to_port(g), I2P, "cpu")
    for name in ("clg_eps_rec", "arc_tab", "hmm_em_rec", "hmm_exit"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert (pg.start, pg.final_state) == (int(jg.start), int(jg.final_state))
    np.testing.assert_array_equal(pil, jil)


def _random_beam(rng, g, B, K):
    """Tokens on CLG states, on HMM virtual states (state 0..n-1 of the
    HMM of a non-ε arc), and dead slots; some costs equal on purpose."""
    clg = g.clg
    emit_arcs = np.where(clg.arc_ilabel != 0)[0]
    state = np.full((B, K), -1, np.int32)
    cost = np.full((B, K), np.inf, np.float32)
    for b in range(B):
        for k in range(K):
            r = rng.random()
            if r < 0.35:
                state[b, k] = rng.integers(0, clg.num_states)
            elif r < 0.8:
                a = int(rng.choice(emit_arcs))
                hs = int(rng.integers(0, g.hmm_of_arc(a).num_states))
                state[b, k] = a + (hs + 1) * g.offset
            else:
                continue
            cost[b, k] = rng.choice([0.0, 1.0, rng.random() * 5])
    return state, cost


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("beam,min_active", [(1e9, 0), (2.0, 3)])
def test_stages_match_jax(seed, beam, min_active):
    """The emitting stage and one ε sweep, slot for slot."""
    rng, g = make_clg(seed)
    jg, _ = J.make_clg_graph_arrays(g, I2P)
    pg, _ = P.make_clg_graph_arrays(to_port(g), I2P, "cpu")
    B, K = 3, 16
    cfg = dict(K=K, Ah=int(pg.hmm_em_rec.shape[1]) // 3,
               Ae=int(pg.clg_eps_rec.shape[1]) // 3, offset=g.offset,
               beam=beam, min_active=min_active, acoustic_scale=0.5)
    state, cost = _random_beam(rng, g, B, K)
    ll = (rng.standard_normal((B, 7)) * 3).astype(np.float32)
    st, co = torch.from_numpy(state), torch.from_numpy(cost)
    jst, jco = jax.numpy.asarray(state), jax.numpy.asarray(cost)
    _assert_same(J._emit_stage(jg, jst, jco, jax.numpy.asarray(ll),
                               cfg=dict(cfg, gather_impl="xla")),
                 P._emit_stage(pg, st, co, torch.from_numpy(ll), cfg=cfg))
    _assert_same(J._eps_stage(jg, jst, jco,
                              cfg=dict(cfg, gather_impl="xla")),
                 P._eps_stage(pg, st, co, cfg=cfg))


def _engines(seed, cfg):
    rng, g = make_clg(seed)
    return (rng, g, J.TpuClgBeamSearch(g, I2P, cfg),
            P.TorchClgBeamSearch(to_port(g), I2P, to_port(cfg),
                                 device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_traceback_lattice_match_jax(seed):
    rng, g, js, ps = _engines(seed, _cfg())
    assert (ps.num_stages, ps.beam_width) == (js.num_stages, js.beam_width)
    ll = (rng.standard_normal((3, 12, 7)) * 3).astype(np.float32)
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False                     # a shorter utterance
    jo, po = js.decode(ll, mask), ps.decode(ll, mask)
    _assert_same(jo, po)
    assert ps.traceback(*po) == js.traceback(*jo)
    jl = js.get_lattices(jo[1], jo[2], ll, mask)
    pl = ps.get_lattices(po[1], po[2], ll, mask)
    assert [x.to_text() for x in pl] == [x.to_text() for x in jl]


def test_chunked_advance_matches_one_advance():
    """Chunks of frames walked as a list of logs give the one-call result."""
    rng, g, _, ps = _engines(4, _cfg())
    ll = (rng.standard_normal((2, 15, 7)) * 3).astype(np.float32)
    want = ps.traceback(*ps.decode(ll))
    state, init_log = ps.init_state(2)
    logs = []
    for lo, hi in ((0, 4), (4, 5), (5, 15)):
        state, log = ps.advance(state, ll[:, lo:hi])
        logs.append(log)
    assert ps.traceback(state, init_log, logs) == want


def test_batched_matches_single():
    rng, g, _, ps = _engines(7, _cfg(beam_width=256, max_active=256))
    lls = (rng.standard_normal((3, 9, 7)) * 3).astype(np.float32)
    batch = ps.traceback(*ps.decode(lls))
    for b in range(3):
        assert ps.traceback(*ps.decode(lls[b:b + 1]))[0] == batch[b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_gold(seed):
    cfg = _cfg(beam_width=256, max_active=256, lattice_beam=1e9)
    rng, g, _, ps = _engines(seed, cfg)
    ll = (rng.standard_normal((12, 7)) * 3).astype(np.float32)
    gold = GoldClgDecoder(g, I2P, cfg).decode(ll)
    res = ps.traceback(*ps.decode(ll[None]))[0]
    assert res["reached_final"] == gold.reached_final
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res["words"] == gold.words
        assert res["ilabels"] == gold.ilabels


def test_log_snapshots_off():
    """Zero-width snapshots, the same traceback, and lattices refused."""
    rng, g, _, ps = _engines(2, _cfg())
    ll = (rng.standard_normal((2, 8, 7)) * 3).astype(np.float32)
    off = P.TorchClgBeamSearch(to_port(g), I2P,
                               to_port(_cfg(log_snapshots=False)),
                               device="cpu")
    state, init_log, logs = off.decode(ll)
    assert tuple(logs.tok_state.shape) == (8, 2, 0)
    assert off.traceback(state, init_log, logs) == \
        ps.traceback(*ps.decode(ll))
    with pytest.raises(RuntimeError, match="log_snapshots"):
        off.get_lattices(init_log, logs, ll)
