"""The manifest against the benchmark's contract: names, units, the
files each entry names, and what each cell reports."""

import json
import re
import subprocess
import sys
import shutil

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = harness.manifest()


def test_keys_names_and_units():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    for n in names:
        assert NAME.match(n), n
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    assert len({e["name"] for e in M["end_to_end"] + M["per_layer"]}) == \
        len(M["end_to_end"]) + len(M["per_layer"])
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.ROOT / c["file"]).exists()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_every_piece_is_found_by_name():
    for w in M["workloads"]:
        c = harness.cell(w["name"])
        assert (harness.HERE / "traffic" /
                f"{c.workload['kind']}.py").exists()
        for m in c.per_layer:
            assert callable(harness.metric_reader(m["name"]))


def test_each_cell_reports_what_its_metrics_move():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    for w in M["workloads"]:
        c = harness.cell(w["name"])
        reported = {e["name"] for e in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  harness.cell(cell).end_to_end}, m["name"]


def test_a_dummy_cell_from_new_files_alone(tmp_path):
    """A later change adds a cell by adding a workload file and manifest
    entries; no file of the benchmark is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(M))
    m["workloads"].append({"name": "tlg2m.dummy", "config": "tlg2m",
                           "traffic": "dummy", "chips": 1, "why": "test"})
    m["end_to_end"][[e["name"] for e in m["end_to_end"]].index(
        "offline_audio_s_per_s")]["workloads"].append("tlg2m.dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    wl = json.loads((harness.HERE / "workloads" /
                     "tlg2m.offline.json").read_text())
    (root / "benchmark" / "workloads" / "tlg2m.dummy.json").write_text(
        json.dumps(wl))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    from benchmark.tests.conftest import tiny
    code = ("import json, sys; from benchmark import run; "
            f"r = run.run_cell('tlg2m.dummy', 5, 1.0, False, 'cpu', "
            f"{tiny('tlg2m.offline')!r}); print(json.dumps(r))")
    env = {"PYTHONPATH": f"{root}:{harness.ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and "offline_audio_s_per_s" in r["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_refuses_without_a_card_and_alone(tmp_path):
    """No CUDA device: exit non-zero, no result.  A directory holding only
    the benchmark: exit non-zero, no result."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "tlg2m.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0 and not out.stdout.strip()
    alone = tmp_path / "alone"
    shutil.copytree(harness.HERE, alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", alone)
    code = ("import json; from benchmark import run; print(json.dumps("
            "run.run_cell('tlg2m.offline', 1, 1.0, False, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=alone,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "PYTHONPATH": str(alone)})
    assert out.returncode != 0 and not out.stdout.strip()
    assert "asr_decoder_tpu_torch" in out.stderr
