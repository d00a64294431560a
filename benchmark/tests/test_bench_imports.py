"""What the benchmark imports: the reference nothing of the program, of
``jax`` or of the JAX package; nothing of the benchmark any of ``jax``,
``jaxlib``, ``flax`` or the JAX package.  Names are compared whole, by
their top-level part: ``asr_decoder_tpu_torch`` is not ``asr_decoder_tpu``."""

import ast
import sys
import types
from pathlib import Path

from benchmark import harness

JAX_SIDE = {"jax", "jaxlib", "flax", "asr_decoder_tpu"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    files = sorted((harness.HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        found = top_level_imports(f) & (JAX_SIDE | {"asr_decoder_tpu_torch"})
        assert not found, (f, found)


def test_benchmark_imports_nothing_of_jax():
    for f in sorted(harness.HERE.rglob("*.py")):
        if "tests" in f.parts:
            continue
        assert not top_level_imports(f) & JAX_SIDE, f


def test_whole_names_are_compared():
    assert top_level_imports(Path(harness.HERE / "traffic" / "serve.py")) \
        & {"asr_decoder_tpu_torch"}
    assert "asr_decoder_tpu_torch" not in harness.FORBIDDEN


def test_run_time_check_finds_a_planted_jax(monkeypatch):
    import benchmark.tests.conftest  # noqa: F401  (a benchmark module)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == sorted(set(before) | {"jax"})
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "asr_decoder_tpu_torch_x",
                        types.ModuleType("asr_decoder_tpu_torch_x"))
    assert harness.forbidden_modules() == before


def test_main_refuses_a_loaded_jax(monkeypatch, capsys):
    """``run.main`` prints no result and exits non-zero when a forbidden
    module is loaded once the window has closed (the card's look is
    skipped; the run is a tiny CPU one)."""
    from benchmark import run
    from benchmark.tests.conftest import tiny
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = run.run_cell

    def cpu_run(*a, **kw):
        out = real(*a, device="cpu", overrides=tiny("tlg2m.offline"))
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        return out
    monkeypatch.setattr(run, "run_cell", cpu_run)
    try:
        rc = run.main(["--workload", "tlg2m.offline", "--seed", "3",
                       "--seconds", "1", "--trace", "0"])
    finally:
        sys.modules.pop("jaxlib", None)
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""
