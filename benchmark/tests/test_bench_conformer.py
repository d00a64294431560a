"""The full-context Conformer's cell, ``conformer_l.offline``, at a tiny
size on the CPU: it runs, traced and untraced, and is correct; each
planted fault of the AM comes out not correct; the FLOP count its
metrics read against a count of the reference's products at the
configuration's widths; its readers give nothing, and raise nothing,
where the program keeps no counters."""

import json
import types
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import conformer, harness, run
from benchmark.reference import am as ref_am
from benchmark.reference import conformer as ref_conformer

CELL = "conformer_l.offline"
TINY = {"config": {"am": {"feat_dim": 20, "d_model": 32, "heads": 4,
                          "blocks": 2, "ffn_dim": 64, "conv_kernel": 8,
                          "num_pdfs": 20},
                   "fbank": {"num_bins": 20},
                   "graph": {"kind": "random_hclg", "num_states": 300,
                             "num_ilabels": 20},
                   "search": {"beam": 1000.0, "beam_width": 512,
                              "max_active": 512, "min_active": 4,
                              "arc_lanes": 8, "eps_mode": "closure"}},
        "params": {"utterances": 8, "batch": 4,
                   "length": {"median_s": 1.0, "sigma": 0.5, "min_s": 0.5,
                              "max_s": 2.0},
                   "sample_rows": 3}}


def tiny():
    return json.loads(json.dumps(TINY))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    r = run.run_cell(CELL, 2**31 + 12345, 2.0, trace, "cpu", tiny())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        m = r["metrics"]
        assert 0 < m["am_share_pct.conformer"]["value"] < 100
        # 4-row batches of the tiny pool's sorted lengths, by arithmetic
        assert 0 < m["pad_pct.conformer"]["value"] < 50
        assert m["captures.offline"]["value"] == 0
    else:
        assert set(r["metrics"]) == {"offline_audio_s_per_s", "setup_s"}


def _namespace(module, **over):
    """``module`` with some attributes replaced."""
    ns = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module)
                                  if not k.startswith("__")})
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _tf32_products():
    """Every product of the AM's layers with TF32 operands."""
    t = ref_am.tf32
    f = _namespace(
        F, linear=lambda x, w, b=None: F.linear(t(x), t(w), b),
        conv2d=lambda x, w, b=None, **kw: F.conv2d(t(x), t(w), b, **kw),
        conv1d=lambda x, w, b=None, **kw: F.conv1d(t(x), t(w), b, **kw))
    th = _namespace(torch, matmul=lambda a, b: torch.matmul(t(a), t(b)),
                    bmm=lambda a, b: torch.bmm(t(a), t(b)))
    return {"F": f, "torch": th}


FAULTS = {
    "rel_position_dropped": lambda L: {
        "rel_positions": lambda T, d, dev: torch.zeros(2 * T - 1, d,
                                                       device=dev)},
    "key_mask_dropped": lambda L: {
        "Conformer._mhsa": lambda self, x, valid, _o=L.Conformer._mhsa:
            _o(self, x, None)},
    "conv_padding_swapped": lambda L: {"F": _namespace(
        F, pad=lambda x, p: F.pad(x, (p[1], p[0])))},
    "batch_norm_skipped": lambda L: {"F": _namespace(
        F, batch_norm=lambda x, *a, **kw: x)},
    "tf32_operands": lambda L: _tf32_products(),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, monkeypatch):
    from asr_decoder_tpu_torch.models import layers as L
    for name, value in FAULTS[fault](L).items():
        if name.startswith("Conformer."):
            monkeypatch.setattr(L.Conformer, name.split(".")[1], value)
        else:
            monkeypatch.setattr(L, name, value)
    r = run.run_cell(CELL, 4242, 2.0, False, "cpu", tiny())
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("frames", [340, 1998])
def test_flop_count_against_the_reference(frames):
    """At the configuration's widths, on meta tensors: the count the
    metrics read, for one row of ``frames`` fbank frames, against
    ``torch``'s count of the reference's products, within 0.5%.  That
    count holds the positional projection, which the program forms once a
    batch and the metrics leave out (taken off here), and no depthwise
    taps (it counts matrix products and convolutions only)."""
    from torch.utils.flop_counter import FlopCounterMode
    am = harness.cell(CELL).config["am"]
    layers = [(kind, {k: torch.empty(s, device="meta")
                      for k, s in shapes.items()})
              for kind, _, _, _, shapes in conformer.layer_specs(am)]
    for kind, p in layers:
        if kind == "prior":
            p["log_priors"] = torch.empty(am["num_pdfs"], device="meta")
    feats = torch.empty(frames, am["feat_dim"], device="meta")
    with FlopCounterMode(display=False) as count:
        y = ref_conformer.forward(layers, feats)
    T = y.shape[0]
    assert T == ((frames - 1) // 2 - 1) // 2
    ours = conformer.am_flops(am, T, T * T)
    pos = am["blocks"] * (2 * T - 1) * 2 * am["d_model"] ** 2
    theirs = count.get_total_flops() - pos
    assert abs(ours / theirs - 1) < 0.005, (ours, theirs)


def test_readers_give_nothing_without_counters():
    from benchmark.harness import metric_reader
    data = {"window": (0.0, 10.0), "config": {"am": tiny()["config"]["am"]},
            "peaks": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
            "steps": [(1.0, 2.0, 1.5, 1.8, 10, 100)],
            "am_steps": [(1.1, 1.4, None)], "K": 16, "stages": 2,
            "lanes": 8}
    for name in ("am_mfu.conformer", "step_mfu.conformer",
                 "pad_pct.conformer"):
        assert metric_reader(name)(data) is None, name
    assert metric_reader("am_share_pct.conformer")(data) == \
        pytest.approx(30.0)
    data["am_steps"] = [(1.1, 1.4, [40, 30, 300])]
    assert metric_reader("pad_pct.conformer")(data) == pytest.approx(25.0)
    mfu = metric_reader("am_mfu.conformer")(data)
    want = conformer.am_flops(data["config"]["am"], 30, 300) / 67e12 / 0.3
    assert mfu == pytest.approx(100 * want)
    assert 0 < metric_reader("step_mfu.conformer")(data) < 100


def test_pool_is_eight_sorted_buckets():
    """1,024 lengths sorted into 8 batches of 128: their longest rows,
    the same for every seed, and 16.5% padding by arithmetic."""
    from benchmark.traffic.offline_bucketed import pool_rows
    p = harness.cell(CELL).workload["params"]
    a, b = pool_rows(p, 1), pool_rows(p, 2**31 + 99)
    assert len(a) == 8 and all(len(x) == 128 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.round([x.max() / 16000 for x in a], 1).tolist() == \
        [3.4, 4.3, 5.1, 6.0, 7.0, 8.4, 10.7, 20.0]
    pad = 1 - sum(x.sum() for x in a) / sum(x.max() * 128 for x in a)
    assert 0.16 < pad < 0.17


def _tiny_ctx(seed):
    cell = harness.cell(CELL)
    for section, over in tiny().items():
        (cell.config if section == "config" else cell.workload[section]) \
            .update(over)
    return harness.Context(cell, seed, 2.0, False, torch.device("cpu"), 0.0)


def test_tf32_control_is_not_correct():
    """The TF32 reference and an exact Viterbi in the program's place,
    judged by the cell's comparison: real paths, caught by ``am_err``."""
    from benchmark.control_conformer import control_checks
    checks = control_checks(_tiny_ctx(4242), 3)
    assert set(checks) == {"am_err", "cost_err", "path_faults", "beam_gap"}
    assert checks["path_faults"][0] == 0
    assert checks["am_err"][0] > checks["am_err"][1]
    assert not harness.correct(checks)


def test_width_control_cuts_the_program_only():
    """``narrowed(1)``: the program's search keeps one token, the judge's
    keeps the configuration's width, and the cut is caught."""
    from asr_decoder_tpu_torch.ops import beamsearch
    from benchmark.control_conformer import narrowed
    built = []
    made = beamsearch.TorchBeamSearch

    def spy(*a, **kw):
        s = made(*a, **kw)
        built.append(s.beam_width)
        return s
    with mock.patch.object(beamsearch, "TorchBeamSearch", spy), narrowed(1):
        r = run.run_cell(CELL, 4242, 2.0, False, "cpu", tiny())
    assert built == [1]
    assert r["checks"]["beam_gap"]["value"] > r["checks"]["beam_gap"]["limit"]
    assert not r["correct"]
