"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one card: no exchange between
chips to leave out), and a search cut to one token a frame, whose paths
are sound but not the best ones."""

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import CELLS, manifest, tiny


def _unchanged(orig):
    def advance(self, state, loglikes, frame_mask=None):
        _, logs = orig(self, state, loglikes, frame_mask)
        return state, logs
    return advance


def _half(orig):
    def advance(self, state, loglikes, frame_mask=None):
        new, logs = orig(self, state, loglikes, frame_mask)
        half = torch.arange(new[0].shape[0]) < new[0].shape[0] // 2
        return type(new)(*(torch.where(half[:, None].to(n.device), o, n)
                           for o, n in zip(state, new))), logs
    return advance


def _word(orig):
    def traceback(self, *a, **kw):
        res = orig(self, *a, **kw)
        for r in res:
            if "words" in r:
                r["words"] = [w + 1 for w in r["words"]] or [1]
        return res
    return traceback


def _cost(orig):
    def traceback(self, *a, **kw):
        res = orig(self, *a, **kw)
        for r in res:
            r["cost"] = r["cost"] * 1.001 + 0.01
        return res
    return traceback


def _loglikes(orig):
    def call(self, x, state, **flags):
        y, new = orig(self, x, state, **flags)
        return y + 1e-2, new
    return call


def _width(orig):
    def init(self, dev, ilabel2pdf, config=None, **kw):
        config = dataclasses.replace(config, beam_width=1, max_active=1,
                                     min_active=1)
        orig(self, dev, ilabel2pdf, config, **kw)
    return init


FAULTS = {"state_unchanged": ("advance", _unchanged),
          "half_batch_left_out": ("advance", _half),
          "word_altered": ("traceback", _word),
          "cost_altered": ("traceback", _cost),
          "loglikes_altered": ("am", _loglikes),
          "search_width_cut": ("__init__", _width)}


CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if not (c == "tlg2m.offline" and FAULTS[f][0] == "am")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    from asr_decoder_tpu_torch.models.nnet import GraphedAm
    from asr_decoder_tpu_torch.ops.beamsearch import TorchBeamSearch
    where, make = FAULTS[fault]
    if where == "am":
        monkeypatch.setattr(GraphedAm, "__call__",
                            make(GraphedAm.__call__))
    else:
        monkeypatch.setattr(TorchBeamSearch, where,
                            make(getattr(TorchBeamSearch, where)))
    # at the tiny size a one-token search finds the best path on some
    # seeds (seed 3 of the served cell's tiny graph, for one); not on 1
    seed = 1 if fault == "search_width_cut" else 4242
    r = run.run_cell(cell, seed, 2.0, False, "cpu", tiny(cell), manifest())
    assert not r["correct"], r["checks"]
