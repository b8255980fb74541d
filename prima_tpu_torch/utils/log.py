"""Leveled, timestamped logger (the common/log.cpp analogue).

Env: PRIMA_LOG_LEVEL (debug|info|warn|error), PRIMA_LOG_COLORS=0/1,
PRIMA_LOG_FILE=path. The reference's ring-buffer async writer becomes a
plain locked stream — Python's GIL makes the async buffer pointless.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 99}
_COLORS = {"debug": "\x1b[90m", "info": "", "warn": "\x1b[33m", "error": "\x1b[31m"}
_RESET = "\x1b[0m"

_lock = threading.Lock()
_level = _LEVELS.get(os.environ.get("PRIMA_LOG_LEVEL", "info"), 20)
_colors = os.environ.get("PRIMA_LOG_COLORS", "1") != "0" and sys.stderr.isatty()
_file = None
if os.environ.get("PRIMA_LOG_FILE"):
    _file = open(os.environ["PRIMA_LOG_FILE"], "a")
_t0 = time.time()


def set_level(name: str) -> None:
    global _level
    _level = _LEVELS.get(name, 20)


def _emit(level: str, msg: str, *args) -> None:
    if _LEVELS[level] < _level:
        return
    if args:
        msg = msg % args
    ts = time.time() - _t0
    line = f"[{ts:9.3f}] [{level:5s}] {msg}"
    with _lock:
        if _colors and _COLORS[level]:
            sys.stderr.write(_COLORS[level] + line + _RESET + "\n")
        else:
            sys.stderr.write(line + "\n")
        if _file is not None:
            _file.write(line + "\n")
            _file.flush()


def debug(msg: str, *args) -> None:
    _emit("debug", msg, *args)


def info(msg: str, *args) -> None:
    _emit("info", msg, *args)


def warn(msg: str, *args) -> None:
    _emit("warn", msg, *args)


def error(msg: str, *args) -> None:
    _emit("error", msg, *args)
