"""Each cell through the harness end to end at a tiny size on the CPU,
traced and untraced, the plain reference agreeing."""

import pytest

from benchmark import run
from benchmark.tests.conftest import CELLS, manifest, tiny


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    r = run.run_cell(cell, 2**31 + 12345, 2.0, trace, "cpu", tiny(cell),
                     manifest())
    assert r["correct"], r["checks"]
    assert list(r) == (["correct", "attempted", "failed", "metrics",
                        "device"] + (["breakdown"] if trace else [])
                       + ["checks"])
    assert r["attempted"] > 0 and r["failed"] == 0
    if not trace:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert r["metrics"]       # the host-clock readers; no device ones
        assert not any(k.startswith(("gather_roofline", "device_idle",
                                     "step_mfu")) for k in r["metrics"])
