"""The port covers the JAX package's public API.

Every top-level public function, class and constant of each
``asr_decoder_tpu/**.py``, and every public method of its classes, has a
same-named counterpart in the mirrored ``asr_decoder_tpu_torch/`` module,
or an entry in ``COUNTERPARTS``.  An entry is either the port object that
takes its place, written ``"module:attr"`` and resolved here, or the
reason the port has none.  A class renamed through an entry carries its
methods to the new class, where each must exist under its own name.

The JAX side is read by ``ast`` alone (nothing of it is imported); the
port's modules are imported and their attributes looked up, so a name
counts wherever the port binds it (defined, imported or inherited).
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
    "wakeup/dtw.py:INF":
        "jnp.inf as a module constant; the port fills with float('inf') "
        "where it pads",
}

_TARGET = re.compile(r"^[\w.]+:[\w.]+$")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _top_level(body):
    """Statements at module level, through ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
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
            out += [n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name) and _public(n.id)]
    return list(dict.fromkeys(out))


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
    for key in COUNTERPARTS:
        rel, name = key.split(":")
        assert name in public_names(JAX / rel), f"stale entry {key}"


@pytest.mark.parametrize("rel", MODULES)
def test_port_covers_module(rel):
    port = importlib.import_module(_port_module(Path(rel)))
    missing = []
    for name in public_names(JAX / rel):
        key = f"{rel}:{name}"
        entry = COUNTERPARTS.get(key)
        if entry is None and "." in name:
            cls, meth = name.split(".", 1)
            renamed = COUNTERPARTS.get(f"{rel}:{cls}")
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
    assert not missing, (f"{_port_module(Path(rel))} lacks {missing}: port "
                         "them or state the reason in COUNTERPARTS")
