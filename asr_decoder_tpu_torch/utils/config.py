"""Kaldi-style ``--key=value`` configuration system.

Capability parity with the reference's ``ConfigParseOptions``
(ref: src/util/config-parse-options.h:20-101): typed option registration,
``--config=FILE`` indirection, prefix scoping for sub-module option groups
(e.g. ``--nnet-vad-judge.left-context=...``), standard flags, and positional
arguments.  Re-designed as a plain-Python registry (no macros, no globals).
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable


def _parse_bool(s: str) -> bool:
    if isinstance(s, bool):
        return s
    t = s.strip().lower()
    if t in ("true", "t", "1", "yes", "on"):
        return True
    if t in ("false", "f", "0", "no", "off", ""):
        return False
    raise ValueError(f"cannot parse boolean from {s!r}")


_PARSERS: dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s, 0),
    float: float,
    str: str,
}


@dataclass
class _Option:
    name: str          # canonical dashed name, e.g. "max-active"
    doc: str
    getter: Callable[[], Any]
    setter: Callable[[Any], None]
    typ: type
    disabled: bool = False


def _dash(name: str) -> str:
    return name.strip().replace("_", "-")


class ConfigOptions:
    """Typed option registry + command-line / config-file parser.

    Usage::

        opts = ConfigOptions(usage="my-tool [options] graph words")
        cfg = DecoderConfig()
        cfg.register(opts)                      # dataclasses register themselves
        opts.register("beam", get, set, "doc")  # or manual registration
        positional = opts.parse(argv)
    """

    def __init__(self, usage: str = ""):
        self._usage = usage
        self._opts: dict[str, _Option] = {}
        self.verbose: int = 0
        self.print_args: bool = False
        self.log_file: str = ""
        self.register_simple(self, "verbose", "Verbosity level for vlog messages")
        self.register_simple(self, "print_args", "Print command-line arguments")
        self.register_simple(self, "log_file", "Redirect logging to this file")

    # -- registration ------------------------------------------------------
    def register(self, name: str, getter: Callable[[], Any],
                 setter: Callable[[Any], None], doc: str = "",
                 typ: type | None = None, prefix: str = "") -> None:
        if typ is None:
            typ = type(getter())
        key = _dash((prefix + "." if prefix else "") + name)
        self._opts[key] = _Option(key, doc, getter, setter, typ)

    def register_simple(self, obj: Any, attr: str, doc: str = "",
                        prefix: str = "") -> None:
        """Register an object attribute as an option named after it."""
        self.register(
            _dash(attr),
            lambda o=obj, a=attr: getattr(o, a),
            lambda v, o=obj, a=attr: setattr(o, a, v),
            doc, type(getattr(obj, attr)), prefix,
        )

    def register_dataclass(self, dc: Any, prefix: str = "") -> None:
        """Register every field of a dataclass instance as an option.

        Mirrors the reference pattern where each module exposes
        ``Register(ConfigParseOptions*)``; prefix scoping mirrors
        ``ConfigParseOptions(prefix, opts)`` (ref: src/online-vad/online-vad.h:103).
        """
        assert is_dataclass(dc), dc
        for f in fields(dc):
            if not f.metadata.get("no_flag", False):
                doc = f.metadata.get("help", "")
                self.register_simple(dc, f.name, doc, prefix)

    def disable(self, name: str) -> None:
        """ref: ConfigParseOptions::DisableOption."""
        self._opts[_dash(name)].disabled = True

    # -- parsing -----------------------------------------------------------
    def _set(self, key: str, val: str) -> None:
        key = _dash(key)
        if key not in self._opts:
            raise KeyError(f"unknown option --{key}")
        opt = self._opts[key]
        if opt.disabled:
            raise KeyError(f"option --{key} is disabled")
        if opt.typ is bool and val is None:
            opt.setter(True)
        else:
            opt.setter(_PARSERS.get(opt.typ, opt.typ)(val))

    def read_config_file(self, path: str) -> None:
        """ref: ConfigParseOptions::ReadConfigFile — one --key=value per line."""
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                for tok in shlex.split(line):
                    self._parse_token(tok)

    def _parse_token(self, tok: str) -> None:
        assert tok.startswith("--"), tok
        body = tok[2:]
        if "=" in body:
            key, val = body.split("=", 1)
        else:
            key, val = body, None
        if _dash(key) == "config":
            self.read_config_file(val)
        elif _dash(key) == "help":
            raise SystemExit(self.usage())
        else:
            self._set(key, val)

    def parse(self, argv: list[str]) -> list[str]:
        """Parse argv (no program name); returns positional args."""
        positional: list[str] = []
        for tok in argv:
            if tok.startswith("--"):
                self._parse_token(tok)
            else:
                positional.append(tok)
        if self.print_args:
            print(" ".join(argv))
        return positional

    def usage(self) -> str:
        lines = [self._usage, "", "Options:"]
        for key in sorted(self._opts):
            o = self._opts[key]
            if not o.disabled:
                lines.append(f"  --{key:<30} {o.doc} "
                             f"({o.typ.__name__}, default = {o.getter()!r})")
        return "\n".join(lines)

    def get(self, name: str) -> Any:
        return self._opts[_dash(name)].getter()


def flag(default: Any, help: str = "", **meta: Any):  # noqa: A002
    """Dataclass field helper carrying flag metadata."""
    return field(default=default, metadata={"help": help, **meta})
