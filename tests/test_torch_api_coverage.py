"""The port covers the JAX package's public API.

Every top-level public function, class and constant of each
``asr_decoder_tpu/**.py``, and every public method of its classes, has a
same-named counterpart in the mirrored ``asr_decoder_tpu_torch/`` module,
or an entry in ``COUNTERPARTS``.  An entry is either the port object that
takes its place, written ``"module:attr"`` and resolved here, or the
reason the port has none.  A class renamed through an entry carries its
methods to the new class, where each must exist under its own name.

The JAX package's root scripts (``bench.py``, ``eval.py``,
``__graft_entry__.py``, ``tools/perf/*.py``) are held the same way to the
port modules that take their place (``SCRIPTS``), with their own entries in
``SCRIPT_COUNTERPARTS``.  Names bound only under ``if __name__ ==
"__main__":`` are a script's locals, not its API, and are not counted.

The JAX side is read by ``ast`` alone (nothing of it is imported); the
port's modules are imported and their attributes looked up, so a name
counts wherever the port binds it (defined, imported or inherited).  An
entry that names a port object may go on, after a space, with a note.
"""

import ast
import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "asr_decoder_tpu"
PORT = "asr_decoder_tpu_torch"

# ``"<module path>:<name>"`` of the JAX package → the port's counterpart
# (``"module:attr"``) or the reason there is none.
COUNTERPARTS = {
    "ops/beamsearch.py:TpuBeamSearch":
        f"{PORT}.ops.beamsearch:TorchBeamSearch",
    "ops/beamsearch_clg.py:TpuClgBeamSearch":
        f"{PORT}.ops.beamsearch_clg:TorchClgBeamSearch",
    "ops/beamsearch_biglm.py:TpuBigLmBeamSearch":
        f"{PORT}.ops.beamsearch_biglm:TorchBigLmBeamSearch",
    "ops/fetch.py:fetch_pages": f"{PORT}.ops.fetch:fetch_records",
    "ops/fetch.py:pack_state_records":
        f"{PORT}.ops.beamsearch:make_packed_graph",
    "ops/fetch.py:PAGE_LANES":
        "the TPU's 128-lane page tile; the port's records are a narrow "
        "[S, lanes] table (make_packed_graph), read 16 bytes at a time",
    "models/layers.py:layer_forward": f"{PORT}.models.layers:Layer.forward",
    "models/layers.py:init_layer_state":
        f"{PORT}.models.layers:Layer.init_state",
    "cli/decode.py:read_wav": f"{PORT}.frontend.audio:decode_audio",
    "parallel/mesh.py:replicated":
        "returns a JAX NamedSharding with an empty PartitionSpec; torch "
        "has no sharding object: a replicated tensor is a copy a device",
    "utils/profiling.py:annotate": f"{PORT}.utils.profiling:span",
    "wakeup/dtw.py:INF":
        "jnp.inf as a module constant; the port fills with float('inf') "
        "where it pads",
}

# the JAX package's root scripts, by path from the repo root → the port
# module that takes each one's place
SCRIPTS = {
    "bench.py": f"{PORT}.tools.bench",
    "eval.py": f"{PORT}.tools.eval",
    "__graft_entry__.py": f"{PORT}.parallel.dryrun",
    "tools/perf/bench_dma_variants.py": f"{PORT}.tools.perf.bench_dma_variants",
    "tools/perf/bench_points.py": f"{PORT}.tools.perf.bench_points",
    "tools/perf/bench_row_gather.py": f"{PORT}.tools.perf.bench_row_gather",
    "tools/perf/profile_production.py":
        f"{PORT}.tools.perf.profile_production",
}

# ``"<script path>:<name>"`` → the port's counterpart or the reason there is
# none, as in ``COUNTERPARTS``
SCRIPT_COUNTERPARTS = {
    "__graft_entry__.py:Nnet_init_state":
        f"{PORT}.models.nnet:Nnet.init_state",
    "tools/perf/profile_production.py:CACHE":
        "a fixed /tmp file; the port caches the graph inside the checkout, "
        "at ops/_build.py:BUILD_DIR / prod_graph_<states>.npz, keyed by "
        "its --states, and writes nothing outside the checkout",
    # one main, whose --tlg chooses the composed TLG as the JAX script's
    # __main__ chooses main_tlg
    "tools/perf/profile_production.py:main_tlg":
        f"{PORT}.tools.perf.profile_production:main",
}

_TARGET = re.compile(r"^[\w.]+:[\w.]+$")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _is_main_guard(node) -> bool:
    t = node.test
    return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
            and t.left.id == "__name__"
            and any(isinstance(c, ast.Constant) and c.value == "__main__"
                    for c in t.comparators))


def _top_level(body):
    """Statements at module level, through ``if`` and ``try`` blocks; the
    body of ``if __name__ == "__main__":`` is a script's, not the
    module's."""
    for node in body:
        if isinstance(node, ast.If) and _is_main_guard(node):
            yield from _top_level(node.orelse)
        elif isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
            yield from _top_level(getattr(node, "finalbody", []))
            for h in getattr(node, "handlers", []):
                yield from _top_level(h.body)
        else:
            yield node


def public_names(path: Path) -> list[str]:
    """Public top-level functions, classes and constants of a module, and
    ``Class.method`` for each public method of its public classes."""
    out = []
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not _public(node.name):
                continue
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _public(m.name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [n for t in targets for n in _bound(t) if _public(n)]
    return list(dict.fromkeys(out))


def _bound(target) -> list[str]:
    """Names an assignment target binds: a name, or the names it unpacks
    into (``os.environ[k] = v`` binds none)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, ast.Starred):
        return _bound(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound(e)]
    return []


def _resolve(target: str):
    mod, attr = target.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _port_module(rel: Path) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join((PORT,) + parts)


MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def test_every_entry_names_a_jax_public_name():
    for table, base in ((COUNTERPARTS, JAX), (SCRIPT_COUNTERPARTS, ROOT)):
        for key in table:
            rel, name = key.split(":")
            assert name in public_names(base / rel), f"stale entry {key}"


def _lacks(port_name: str, path: Path, rel: str, table: dict) -> list[str]:
    """The public names of the JAX file at ``path`` that the port module
    ``port_name`` lacks, entries of ``table`` (keyed by ``rel``) taken
    into account."""
    port = importlib.import_module(port_name)
    missing = []
    for name in public_names(path):
        key = f"{rel}:{name}"
        entry = table.get(key)
        if entry is None and "." in name:
            cls, meth = name.split(".", 1)
            renamed = table.get(f"{rel}:{cls}")
            if renamed is not None and _TARGET.match(renamed):
                entry = f"{renamed}.{meth}"
        if entry is None:
            obj = port
            try:
                for part in name.split("."):
                    obj = getattr(obj, part)
            except AttributeError:
                missing.append(name)
        elif _TARGET.match(entry):
            try:
                _resolve(entry)
            except (AttributeError, ImportError):
                missing.append(f"{name} -> {entry}")
        else:
            assert len(entry.split()) >= 5, f"{key}: state the reason"
    return missing


@pytest.mark.parametrize("rel", MODULES)
def test_port_covers_module(rel):
    port = _port_module(Path(rel))
    missing = _lacks(port, JAX / rel, rel, COUNTERPARTS)
    assert not missing, (f"{port} lacks {missing}: port them or state the "
                         "reason in COUNTERPARTS")


@pytest.mark.parametrize("rel", sorted(SCRIPTS))
def test_port_covers_script(rel):
    port = SCRIPTS[rel]
    missing = _lacks(port, ROOT / rel, rel, SCRIPT_COUNTERPARTS)
    assert not missing, (f"{port} lacks {missing} of {rel}: port them or "
                         "state the reason in SCRIPT_COUNTERPARTS")
