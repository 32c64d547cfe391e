"""Structured logging (hybridrenderer_tpu/runtime/log.py, copied: the
port imports nothing of the JAX package) — the reference's Log component
rebuilt on :mod:`logging` (Log.h:10-30 / Log.cpp:12-22: spdlog core +
client loggers with a ``[%T] %n: %v`` pattern and caller file:line
macros).

Two named channels mirror the reference split:

  * ``core()``   — framework internals (CHIMERA logger analog)
  * ``client()`` — application / sandbox code (APP logger analog)

Records carry caller file:line like the CH_CORE_* macros (Log.h:33-56);
the level comes from ``HR_LOG_LEVEL`` (trace|debug|info|warn|error,
default info — the reference pins info, Log.cpp:17). ``bind(**fields)``
adds structured key=value context.
"""
from __future__ import annotations

import logging
import os
import sys
import time

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _Formatter(logging.Formatter):
    """``[%T] NAME: [file:line] message key=value …`` — the spdlog
    pattern of Log.cpp:14 plus the macros' caller location."""

    def format(self, record):
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        loc = f"[{os.path.basename(record.pathname)}:{record.lineno}]"
        msg = record.getMessage()
        fields = getattr(record, "hr_fields", None)
        if fields:
            msg += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        return f"[{ts}] {record.name} {record.levelname.lower()}: {loc} {msg}"


def _make(name: str) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_Formatter())
        lg.addHandler(h)
        lg.propagate = False
        lg.setLevel(_LEVELS.get(
            os.environ.get("HR_LOG_LEVEL", "info").lower(), logging.INFO))
    return lg


class Channel:
    """Leveled channel with structured-field binding.

    ``core().bind(scene="sponza", tris=262000).info("BVH built")``
    prints ``... CHIMERA info: [x.py:12] BVH built scene=sponza
    tris=262000``.
    """

    def __init__(self, logger: logging.Logger, fields=None):
        self._lg = logger
        self._fields = dict(fields or {})

    def bind(self, **fields) -> "Channel":
        return Channel(self._lg, {**self._fields, **fields})

    def _log(self, level, msg, *args, **fields):
        if self._lg.isEnabledFor(level):
            all_fields = {**self._fields, **fields}
            self._lg.log(level, msg, *args, stacklevel=3,
                         extra={"hr_fields": all_fields})

    def trace(self, msg, *args, **fields):
        self._log(TRACE, msg, *args, **fields)

    def debug(self, msg, *args, **fields):
        self._log(logging.DEBUG, msg, *args, **fields)

    def info(self, msg, *args, **fields):
        self._log(logging.INFO, msg, *args, **fields)

    def warn(self, msg, *args, **fields):
        self._log(logging.WARNING, msg, *args, **fields)

    def error(self, msg, *args, **fields):
        self._log(logging.ERROR, msg, *args, **fields)

    def set_level(self, level: str):
        self._lg.setLevel(_LEVELS[level.lower()])


def core() -> Channel:
    """Framework channel (GetCoreLogger analog, Log.h:15-18)."""
    return Channel(_make("CHIMERA"))


def client() -> Channel:
    """Application channel (GetClientLogger analog, Log.h:19-22)."""
    return Channel(_make("APP"))
