"""The control (``benchmark/control.py``: the reference in the program's
place one precision below the configuration's) comes out not correct
under each cell's limits, at a size the CPU holds: the flagship AM at its
own widths (TF32 operands) over a tiny graph and short utterances for the
AM cells, the tiny TLG (bfloat16 costs) for ``tlg2m.offline``.  The chip runs it at the cells' own sizes
(PERF.md)."""

import copy
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import CELLS, TINY, manifest

CONTROL_AM = {"feat_dim": 80, "context": 1, "proj": 512, "hidden": 1024,
              "num_layers": 3, "num_pdfs": 2048, "skip": 2}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.cell(cell, manifest())
    over = copy.deepcopy(TINY[cell])
    if "am" in over["config"]:
        over["config"]["am"] = dict(CONTROL_AM)
        over["config"]["fbank"] = {"num_bins": CONTROL_AM["feat_dim"]}
        over["config"]["graph"]["num_ilabels"] = CONTROL_AM["num_pdfs"]
    for section, o in over.items():
        (c.config if section == "config" else c.workload[section]).update(o)
    ctx = harness.Context(c, 31337, 3.0, False, torch.device("cpu"),
                          time.monotonic())
    nums = control.control_numbers(ctx)
    checks = {k: (v, ctx.limits[k]) for k, v in nums.items()}
    assert nums["path_faults"] == 0          # the control's paths are sound
    assert not harness.correct(checks), checks
