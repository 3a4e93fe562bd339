"""Leveled logging (common/log.cpp + llama_log_set analog).

A copy of ``rrs_tpu/utils/logging.py``: timestamped, level-filtered, with a
pluggable sink callback (the ``llama_log_set`` mechanism) and env control
via ``RRS_TPU_LOG_LEVEL`` (debug|info|warn|error|none), the JAX package's
variable, so that one setting governs both.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 99}
_level = _LEVELS.get(os.environ.get("RRS_TPU_LOG_LEVEL", "info").lower(), 20)
_sink: Optional[Callable[[int, str], None]] = None
_t0 = time.monotonic()


def set_level(name: str) -> None:
    global _level
    _level = _LEVELS.get(name.lower(), _level)


def log_set(sink: Optional[Callable[[int, str], None]]) -> None:
    """Install a custom sink (llama_log_set analog); None restores stderr."""
    global _sink
    _sink = sink


def _emit(lvl_num: int, lvl_name: str, name: str, msg: str) -> None:
    if lvl_num < _level:
        return
    line = f"[{time.monotonic() - _t0:10.3f}] {lvl_name[0].upper()} {name}: {msg}"
    if _sink is not None:
        _sink(lvl_num, line)
    else:
        print(line, file=sys.stderr, flush=True)


class Logger:
    def __init__(self, name: str):
        self.name = name

    def debug(self, msg, *a):
        _emit(10, "debug", self.name, msg % a if a else msg)

    def info(self, msg, *a):
        _emit(20, "info", self.name, msg % a if a else msg)

    def warn(self, msg, *a):
        _emit(30, "warn", self.name, msg % a if a else msg)

    warning = warn

    def error(self, msg, *a):
        _emit(40, "error", self.name, msg % a if a else msg)


def get_logger(name: str) -> Logger:
    return Logger(name)
