"""The port's BigLM pair search (``asr_decoder_tpu_torch/ops/
beamsearch_biglm.py``) on the CPU against the JAX ``TpuBigLmBeamSearch``
and the host ``GoldBigLmDecoder``.

Tolerance: integer outputs (states, LM states, backpointers, arc ids,
overflow flags, words) are exact everywhere.  Costs are bit-exact with unit
LM scales, where both sides run the same fp32 ops in the same order.  With
other scales XLA on the CPU contracts ``lm2_scale·c2 − lm1_scale·c1`` into
one fused multiply-add and torch does not (one rounding apart), so costs
are held to atol 1e-5 there.  Against the gold decoder costs agree to
1e-3, as in ``tests/test_biglm.py``.
"""

import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.gold import GoldBigLmDecoder  # noqa: E402
from asr_decoder_tpu.lm import device_lm as JL  # noqa: E402
from asr_decoder_tpu.lm.arpa import parse_arpa  # noqa: E402
from asr_decoder_tpu.ops import beamsearch_biglm as J  # noqa: E402
from asr_decoder_tpu_torch.lm import device_lm as PL  # noqa: E402
from asr_decoder_tpu_torch.ops import beamsearch_biglm as P  # noqa: E402

from test_biglm import _setup_biglm  # noqa: E402
from test_lm import ARPA, ARPA2  # noqa: E402
from test_torch_host_copies import to_port  # noqa: E402

EXACT = 1 << 20


@pytest.fixture(scope="module")
def fsas():
    fsa1 = parse_arpa(ARPA)
    return fsa1, parse_arpa(ARPA2, word2id=fsa1.vocab)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(jax_tree, port_tree, cost_atol=0.0):
    for j, p in zip(jax_tree, port_tree):
        if not isinstance(p, torch.Tensor):
            _assert_same(j, p, cost_atol)
            continue
        j, p = np.asarray(j), p.numpy()
        assert j.shape == p.shape and j.dtype == p.dtype
        if p.dtype == np.float32 and cost_atol:
            np.testing.assert_array_equal(np.isfinite(p), np.isfinite(j))
            np.testing.assert_allclose(p, j, rtol=0, atol=cost_atol)
        else:
            np.testing.assert_array_equal(_bits(p), _bits(j))


def _engines(fsas, seed, lm_lanes=EXACT, scales=(1.0, 1.0), **cfg_kw):
    rng, fst, dev, i2p, cfg = _setup_biglm(seed, lm_lanes=lm_lanes,
                                           **cfg_kw)
    js = J.TpuBigLmBeamSearch(dev, i2p, JL.DeviceDiffLm.build(*fsas, *scales),
                              cfg)
    ps = P.TorchBigLmBeamSearch(
        to_port(dev), i2p,
        PL.DeviceDiffLm.build(*to_port(fsas), *scales, device="cpu"),
        to_port(cfg), device="cpu")
    return rng, fst, js, ps


def test_graph_arrays_match_jax(fsas):
    _, _, js, ps = _engines(fsas, 0)
    for name in ("em_rec", "eps_rec"):
        np.testing.assert_array_equal(getattr(ps.graph, name).numpy(),
                                      np.asarray(getattr(js.graph, name)))
    assert (ps.graph.start, ps.graph.final_state) == \
        (int(js.graph.start), int(js.graph.final_state))
    assert (ps.num_stages, ps.beam_width, ps.lm_lanes_bound) == \
        (js.num_stages, js.beam_width, js.lm_lanes_bound)


@pytest.mark.parametrize("M", [64, 40, 12, 3])
def test_apply_lm_matches_jax(fsas, M):
    """Both branches of ``_apply_lm``: M >= N (every lane probed) and
    compaction (stable sort, LM on the first M lanes, drops past M), with
    and without overflow; dead candidates and ε olabels mixed in."""
    rng = np.random.default_rng(M)
    B, N = 3, 40
    ol = np.where(rng.random((B, N)) < 0.3, rng.integers(1, 4, (B, N)), 0)
    ol = ol.astype(np.int32)
    l1 = rng.integers(0, fsas[0].num_states, (B, N)).astype(np.int32)
    l2 = rng.integers(0, fsas[1].num_states, (B, N)).astype(np.int32)
    dst = rng.integers(0, 30, (B, N)).astype(np.int32)
    cand = np.where(rng.random((B, N)) < 0.2, np.inf,
                    rng.random((B, N)) * 5).astype(np.float32)
    src = rng.integers(0, 8, (B, N)).astype(np.int32)
    aid = rng.integers(-2, 50, (B, N)).astype(np.int32)
    args = (ol, l1, l2, dst, cand, src, aid)
    jlm = JL.DeviceDiffLm.build(*fsas)
    cfg = dict(lm_lanes=M, lm1_mask=jlm.lm1.mask, lm2_mask=jlm.lm2.mask,
               lm1_levels=jlm.lm1.levels, lm2_levels=jlm.lm2.levels,
               lm1_probes=jlm.lm1.max_probes, lm2_probes=jlm.lm2.max_probes,
               lm1_scale=1.0, lm2_scale=1.0)
    want = J._apply_lm(J._lm_tables(jlm), *map(jax.numpy.asarray, args),
                       cfg=cfg)
    got = P._apply_lm(PL.DeviceDiffLm.build(*to_port(fsas), device="cpu"),
                      *map(torch.from_numpy, args), lm_lanes=M)
    _assert_same(want, got)
    n_words = ((ol > 0) & np.isfinite(cand)).sum(1)
    assert got[-1].tolist() == (n_words > M).tolist()
    if M == 12:
        assert got[-1].any() and not got[-1].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lm_lanes", [EXACT, 16])
def test_decode_matches_jax(fsas, seed, lm_lanes):
    """Logs, LM lanes, overflow flags, words and costs, with the LM lanes
    exact and undersized (compaction with drops)."""
    rng, fst, js, ps = _engines(fsas, seed, lm_lanes)
    ll = (rng.standard_normal((2, 12, 7)) * 3).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, 8:] = False
    jo, po = js.decode(ll, mask), ps.decode(ll, mask)
    _assert_same(jo, po)
    pres = ps.traceback(*po, to_port(fst))
    assert pres == js.traceback(*jo, fst)
    assert pres[0]["overflowed"] == bool(po[2].overflow[:, 0].any())
    if lm_lanes == EXACT:
        assert not any(r["overflowed"] for r in pres)


def test_overflow_flag_set_when_lanes_undersized(fsas):
    rng, fst, js, ps = _engines(fsas, 1, lm_lanes=2)
    ll = (rng.standard_normal((2, 12, 7)) * 3).astype(np.float32)
    jo, po = js.decode(ll), ps.decode(ll)
    _assert_same(jo, po)
    pres = ps.traceback(*po, to_port(fst))
    assert pres == js.traceback(*jo, fst)
    assert all(r["overflowed"] for r in pres)


def test_decode_matches_jax_scaled(fsas):
    """Scales 0.7 / 1.3: integers exact, costs within the FMA rounding."""
    rng, fst, js, ps = _engines(fsas, 5, scales=(0.7, 1.3))
    ll = (rng.standard_normal((2, 12, 7)) * 3).astype(np.float32)
    jo, po = js.decode(ll), ps.decode(ll)
    _assert_same(jo, po, cost_atol=1e-5)
    for p, j in zip(ps.traceback(*po, to_port(fst)),
                    js.traceback(*jo, fst)):
        assert p["words"] == j["words"] and p["arc_ids"] == j["arc_ids"]
        assert p["cost"] == pytest.approx(j["cost"], abs=1e-5)


def test_undersized_lm_lanes_warns_at_build(fsas):
    """Undersized lm_lanes can drop word candidates (the reference never
    does): a warning at build names the graph-derived safe bound; a safe
    size stays quiet."""
    records = []
    h = logging.Handler()
    h.emit = records.append
    lg = logging.getLogger("asr_decoder_tpu_torch")
    lg.addHandler(h)
    try:
        _, _, _, ps = _engines(fsas, 3, lm_lanes=2)
        msgs = [r.getMessage() for r in records]
        assert any("lm_lanes=2" in m and str(ps.lm_lanes_bound) in m
                   for m in msgs)
        assert ps.lm_lanes_bound > 2
        records.clear()
        _engines(fsas, 3)
        assert not any("lm_lanes" in r.getMessage() for r in records)
    finally:
        lg.removeHandler(h)


def test_traceback_adds_final_lm_cost(fsas):
    """The final token is chosen by graph cost + the diff LM's sentence-end
    cost, and the reported cost includes it.  (Scales 1 and 4: a product by
    a power of two is exact, so JAX's fused multiply-add rounds the same
    and the costs stay bit-exact.)"""
    rng, fst, js, ps = _engines(fsas, 0, scales=(1.0, 4.0))
    ll = (rng.standard_normal((1, 12, 7)) * 3).astype(np.float32)
    state, init_log, logs = ps.decode(ll)
    res = ps.traceback(state, init_log, logs, to_port(fst))[0]
    assert res["reached_final"]
    st, co, l1, l2 = (x.numpy()[0] for x in state)
    finals = np.where(st == ps.dev.final_state)[0]
    totals = [co[k] + ps.difflm.final_host(int(l1[k]), int(l2[k]))
              for k in finals]
    assert res["cost"] == pytest.approx(min(totals), abs=1e-6)
    assert any(ps.difflm.final_host(int(l1[k]), int(l2[k])) != 0
               for k in finals)
    assert res == js.traceback(*js.decode(ll), fst)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_gold_and_lattice(fsas, seed):
    """Best path against the host gold pair decoder; the raw lattice from
    the port's pair-token snapshots equals the JAX one and the gold one."""
    rng, fst, js, ps = _engines(fsas, seed, scales=(0.7, 1.3))
    ps.config.lattice_beam = js.config.lattice_beam = 6.0
    ll = (rng.standard_normal((12, 7)) * 3).astype(np.float32)
    gold = GoldBigLmDecoder(fst, ps._ilabel2pdf, *fsas, 0.7, 1.3,
                            js.config).decode(ll, want_lattice=True)
    state, init_log, logs = ps.decode(ll[None])
    res = ps.traceback(state, init_log, logs, to_port(fst))[0]
    assert not res["overflowed"]
    assert res["reached_final"] == gold.reached_final
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res["words"] == gold.words
        assert res["ilabels"] == gold.ilabels
    lat = ps.get_lattices(init_log, logs, ll[None], to_port(fst))[0]
    assert sorted(lat.to_text().splitlines()) == \
        sorted(gold.lattice.to_text().splitlines())
    jo = js.decode(ll[None])
    assert lat.to_text() == js.get_lattices(jo[1], jo[2], ll[None],
                                            fst)[0].to_text()
