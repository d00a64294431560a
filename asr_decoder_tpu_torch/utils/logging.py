"""Severity + verbosity-leveled logging.

Capability parity with the reference logging macros LOG_ERR/LOG_WARN/LOG_COM/
VLOG_COM/LOG_ASSERT (ref: src/util/log-message.h:116-180), rebuilt on the
stdlib ``logging`` module: thread-safe, stderr or ``--log-file``, and a global
verbosity level gating ``vlog`` messages.
"""

from __future__ import annotations

import logging
import sys

_verbose_level = 0
_root = logging.getLogger("asr_decoder_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(levelname).1s %(asctime)s %(name)s: %(message)s", "%H:%M:%S"))
    _root.addHandler(_h)
    _root.setLevel(logging.INFO)
    _root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _root.getChild(name) if name else _root


def set_verbose_level(level: int) -> None:
    """ref: g_verbose_level (src/util/log-message.h:58)."""
    global _verbose_level
    _verbose_level = level
    _root.setLevel(logging.DEBUG if level > 0 else logging.INFO)


def verbose_level() -> int:
    return _verbose_level


def vlog(level: int, msg: str, *args) -> None:
    """ref: VLOG_COM(level) — emitted only when verbosity >= level."""
    if _verbose_level >= level:
        _root.debug(msg, *args)


def set_log_file(path: str) -> None:
    """ref: --log-file redirection (src/util/log-message.cc)."""
    for h in list(_root.handlers):
        _root.removeHandler(h)
    h = logging.FileHandler(path) if path else logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(levelname).1s %(asctime)s %(name)s: %(message)s", "%H:%M:%S"))
    _root.addHandler(h)
