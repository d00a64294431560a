"""The port's offline tools (``asr_decoder_tpu_torch/tools/{bench,eval}.py``
and ``tools/perf/profile_production.py --tlg``) on the CPU at their quick
sizes, and the bench tool's production point against the JAX search.

Tolerance: none for the production point (the packed frame count, the
packing mask, the words and the arc ids are integers; the costs are held to
the JAX engine's bit for bit, every search op being an exact fp32 add or
compare, a gather or a sort).  The tools' times are host-clock numbers and
are only checked for their keys.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from asr_decoder_tpu.decoder.config import DecoderConfig as JConfig  # noqa: E402
from asr_decoder_tpu.fst.device_fst import DeviceFst as JDeviceFst  # noqa: E402
from asr_decoder_tpu.fst.tlg import build_tlg as jax_build_tlg  # noqa: E402
from asr_decoder_tpu.lm.arpa import parse_arpa as jax_parse_arpa  # noqa: E402
from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text  # noqa: E402
from asr_decoder_tpu.models.nnet import \
    pack_nonblank_frames as jax_pack  # noqa: E402
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch  # noqa: E402
from asr_decoder_tpu_torch.tools import bench  # noqa: E402
from asr_decoder_tpu_torch.tools import eval as eval_tool  # noqa: E402
from asr_decoder_tpu_torch.tools.perf import profile_production  # noqa: E402

from test_torch_host_copies import assert_same  # noqa: E402

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
STATS = {"median", "min", "max", "repeats"}
POINT_KEYS = {"graph_states", "batch", "frames", "relax", "eps_mode", "beam",
              "beam_width", "max_active", "effective_K", "topk_overfetch",
              "search_ms", "search_ms_per_frame", "search_audio_s_per_s",
              "live_mean", "live_max", "kf_bind", "words_mean"}
KF_KEYS = {"cut_K_times_F", "row_frames_at_cut", "row_frames",
           "frames_at_cut", "frames", "max_candidates"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny and the test run has several workers: one
    intra-op thread is as fast and does not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    return lines


def test_bench_quick_prints_one_json_line(capsys, tmp_path):
    assert bench.main(["--quick", "--device", "cpu", "--pairs", "1",
                       f"--profile-dir={tmp_path}"]) == 0
    lines = _json_line(capsys)
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device",
                        "pairs", "timing", "detail"}
    assert out["metric"] == "audio_seconds_per_second_per_gpu"
    assert out["device"].startswith("device: cpu") and out["pairs"] == 1
    assert out["vs_baseline"] == round(out["value"] / 60.0, 3)
    d = out["detail"]
    assert set(d) == {"headline", "production", "realistic", "v2_vs_v3"}
    for name in bench.POINT_FNS:
        r = d[name]
        assert POINT_KEYS <= set(r), POINT_KEYS - set(r)
        assert set(r["search_ms"]) == STATS and r["relax"] == "topk"
        assert set(r["kf_bind"]) == KF_KEYS
        assert r["effective_K"] == min(r["beam_width"], r["max_active"])
        prof = r["profile"]
        assert prof["frames"] == bench.PROFILE_FRAMES and prof["top"]
        assert prof["ops_per_frame"] > 50 and not prof["on_card"]
        assert (tmp_path / name / "trace.json").stat().st_size > 0
    h, p = d["headline"], d["production"]
    assert out["value"] == h["audio_s_per_s"]["median"] > 0
    assert {"am_ms", "pipeline_ms", "audio_s_per_s", "traceback_ms",
            "wave_secs", "am_audio_s_per_s"} <= set(h)
    assert h["batch"] == 4 and h["effective_K"] == 512
    # the threshold in use is stated, with the count at the documented one
    assert p["blank_threshold"] == {"prob": 0.75,
                                    "log": round(float(np.log(0.75)), 5)}
    assert 0 < p["packed_frames"] <= p["packed_frames_at_log_0.95"] \
        <= p["frames"]
    assert p["words_packed_equal_unpacked"]["of"] == p["batch"]
    assert {"graph_build_s", "graph_device_build_s", "graph_save_s",
            "graph_load_s", "graph_upload_s", "graph_cached",
            "graph_get_s",
            "unpacked_search_ms", "pack_ms", "vocab",
            "lm_states"} <= set(p)
    assert p["topk_overfetch"] == 1 and p["kf_bind"]["cut_K_times_F"] == 256
    for name in ("headline", "realistic"):
        e = d["v2_vs_v3"][name]
        assert len(e["pairs_ms"]) == e["of"] == 1
        assert {"v2_median", "v3_median", "v2_faster_in"} <= set(e)


def test_baseline_is_the_jax_benchs():
    """``BASELINE_AUDIO_S_PER_S`` is the JAX ``bench.py``'s constant, read
    from its source (the JAX script imports jax at module level)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    jax_value = [ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and [t.id for t in n.targets] == ["BASELINE_AUDIO_S_PER_S"]]
    assert jax_value == [bench.BASELINE_AUDIO_S_PER_S] == [60.0]


@pytest.mark.parametrize("value", [0.0, 22.6, 1315.5, 1549.04])
def test_vs_baseline_is_the_headline_over_the_node(monkeypatch, capsys,
                                                   value):
    """The JSON line's ``vs_baseline`` is its ``value``, the headline
    pipeline median, over the reference node's 60 audio-s/s, to 3
    places, whatever the other points report."""
    def point(v):
        return lambda device, **kw: bench.PointRun(
            {"audio_s_per_s": {"median": v}})
    monkeypatch.setattr(bench, "POINT_FNS", {
        "headline": point(value), "production": point(-1.0),
        "realistic": point(-2.0)})
    assert bench.main(["--device", "cpu", "--pairs", "1"]) == 0
    out = json.loads(_json_line(capsys)[-1])
    assert out["value"] == value
    assert out["vs_baseline"] == round(value / 60.0, 3)


def test_eval_quick_prints_one_json_line(capsys):
    assert eval_tool.main(["--quick", "--device", "cpu", "--steps", "12",
                           "--utts", "4"]) == 0
    lines = _json_line(capsys)
    out = json.loads(lines[-1])
    assert [ln for ln in lines if ln.startswith("{")] == [lines[-1]]
    assert (out["metric"], out["unit"]) == ("wer", "errors/ref-word")
    d = out["detail"]
    assert {"errors", "ref_len", "subs", "ins", "dels", "ser", "gold_wer",
            "gold_checked", "gold_mismatches", "utts", "frames", "rtf",
            "decode_audio_s_per_s", "operating_point", "ctc_loss",
            "ref_parity", "train_steps", "train_s", "train_steps_per_s",
            "device"} == set(d)
    # the beam the search kept, beside the settings that were asked for
    assert d["operating_point"] == {"beam": 16.0, "beam_width": 2048,
                                    "max_active": 7000, "min_active": 200,
                                    "effective_K": 2048}
    assert d["train_steps"] == 12 and d["utts"] == 4
    assert d["gold_mismatches"] == 0 and d["ref_parity"] is None
    assert d["device"].startswith("device: cpu")


@pytest.fixture(scope="module")
def production():
    return bench.production(CPU, pairs=1, **bench.QUICK["production"])


def test_production_point_matches_jax(production):
    """The production point at a small vocabulary: the port's TLG equals
    the JAX ``build_tlg``'s arc for arc, and on the same posteriors the JAX
    packing and search give the same packed frames, words, arc ids and
    costs."""
    r, k = production.report, production.keep
    tlg = k["tlg"]
    fsa = jax_parse_arpa(synth_arpa_text(**bench.TLG_QUICK, seed=1))
    jfst, ji2p = jax_build_tlg(tlg.lexicon, fsa, tlg.num_phones)
    assert_same(jfst, tlg.fst)
    assert r["graph_arcs"] == jfst.num_arcs and r["lm_states"] == \
        fsa.num_states
    packed, mask = jax_pack(k["raw_host"], 0, thresh=bench.BLANK_THRESH)
    assert packed.shape[1] == r["packed_frames"]
    assert jax_pack(k["raw_host"], 0, thresh=bench.BLANK_THRESH_DOC)[0] \
        .shape[1] == r["packed_frames_at_log_0.95"]
    np.testing.assert_array_equal(k["packed"].numpy(), packed)
    np.testing.assert_array_equal(k["pmask"].numpy(), mask)
    search = TpuBeamSearch(JDeviceFst.build(jfst, arc_lanes=16),
                           np.asarray(ji2p, np.int32), JConfig(**k["cfg_kw"]))
    assert search.relax_impl == r["relax"] == "topk"
    assert search.beam_width == r["effective_K"]
    for ll, m, want in ((packed, mask, k["results"]),
                        (k["raw_host"], None, k["unpacked"])):
        got = search.traceback(*search.decode(ll, m), jfst)
        assert got == want
    assert all(x["words"] for x in k["results"])
    # the K·F counter counts the packed frames each row really ran
    assert r["kf_bind"]["row_frames"] == int(mask.sum())
    assert r["kf_bind"]["frames"] == r["packed_frames"]


def test_tlg_cache_round_trip(production):
    """``build_or_load_tlg`` loads what it saved: the graph, the device
    graph with its closure, the lexicon and the generator's state (the
    posteriors drawn after a load equal those drawn after a build)."""
    tlg = production.keep["tlg"]
    again = bench.build_or_load_tlg(bench.TLG_QUICK)
    assert again.cached
    assert_same(vars(tlg.fst), vars(again.fst))
    assert_same(vars(tlg.dev), vars(again.dev))
    assert tlg.lexicon == again.lexicon and list(tlg.lexicon) == \
        list(again.lexicon)
    np.testing.assert_array_equal(tlg.i2p, again.i2p)
    assert (again.lm_states, again.build_s) == (tlg.lm_states, tlg.build_s)
    np.testing.assert_array_equal(
        bench._tlg_posteriors(again.rng, again.lexicon, again.num_phones,
                              4, 66), production.keep["raw_host"])


def test_kf_bind_counts_candidates():
    """The K·F counter on a case worked by hand: two tokens with 3 and 2
    emitting arcs enter a frame; the cut is K·F = 4."""
    from types import SimpleNamespace as NS
    search = NS(relax_impl="topk", beam_width=2, A=4, device=CPU,
                config=NS(topk_overfetch=2),
                dev=NS(em_count=np.array([3, 2, 0, 1], np.int32)))
    init = NS(tok_state=torch.tensor([[0, 1], [3, -1]], dtype=torch.int32))
    logs = NS(tok_state=torch.tensor(
        [[[2, 1 | bench.CLO_BIT], [0, 3]], [[0, 0], [0, 0]]],
        dtype=torch.int32))
    got = bench.kf_bind(search, init, logs)
    # frame 0 enters with (3+2, 1), frame 1 with (0+2, 3+1)
    assert got == {"cut_K_times_F": 4, "row_frames_at_cut": 2,
                   "row_frames": 4, "frames_at_cut": 2, "frames": 2,
                   "max_candidates": 5}
    masked = bench.kf_bind(search, init, logs,
                           torch.tensor([[False, True], [True, True]]))
    assert masked["row_frames"] == 3 and masked["row_frames_at_cut"] == 1
    search.relax_impl = "sort"
    assert bench.kf_bind(search, init, logs) is None


def test_profile_production_tlg_smoke(capsys, tmp_path):
    """``profile_production --tlg`` (the JAX tool's ``main_tlg``) at the
    quick LM: it times an advance over the packed posteriors and reports a
    profile of its first frames."""
    profile_production.main(["--device", "cpu", "--tlg", "--lm", "quick",
                             "--batch", "2", "--beam-width", "64",
                             "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "advance wall" in out and "ops/frame" in out
    assert "range search/emit3" in out
    assert (tmp_path / "trace.json").stat().st_size > 0
