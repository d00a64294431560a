"""On a card: a tiny cell traced end to end reads the device trace (busy
time, the gather's roofline, the idle share, the step's share of the
peak) and stays correct.  Skips without a card, decided in the test."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hclg200k.offline", "tlg2m.offline"])
def test_traced_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_cell(cell, 99, 2.0, True, "cuda", tiny(cell))
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for k in ("gather_roofline.offline", "device_idle_pct.offline",
              "step_mfu.offline"):
        assert 0 < r["metrics"][k]["value"] <= 100, (k, r["metrics"])
