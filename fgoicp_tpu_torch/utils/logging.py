"""Leveled, colored, timestamped logger.

Functional parity with the reference's RAII stream logger
(reference fgoicp/common.hpp:171-269): four levels, ANSI colors,
HH:MM:SS timestamps, Debug suppressed unless verbose, and dedicated
formatters for 3-vectors and 3x3 matrices.
"""

from __future__ import annotations

import sys
import time
from enum import Enum

import numpy as np


class LogLevel(Enum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3


_COLORS = {
    LogLevel.DEBUG: "\033[34m",   # blue
    LogLevel.INFO: "\033[32m",    # green
    LogLevel.WARNING: "\033[33m", # yellow
    LogLevel.ERROR: "\033[31m",   # red
}
_RESET = "\033[0m"

_verbose = False


def set_verbose(verbose: bool) -> None:
    """Enable/disable Debug-level output (reference: Logger::set_verbose)."""
    global _verbose
    _verbose = verbose


def get_verbose() -> bool:
    return _verbose


def format_vec3(v) -> str:
    """Reference formats vec3 as tab-separated 6-decimal floats
    (common.hpp:194-199)."""
    v = np.asarray(v).reshape(-1)
    return "\t".join(f"{float(x):.6f}" for x in v[:3])


def format_mat3(m) -> str:
    """Reference formats mat3 row-major, 4 decimals, tab-indented
    (common.hpp:201-209)."""
    m = np.asarray(m).reshape(3, 3)
    rows = ["\t" + "\t".join(f"{float(x):.4f}" for x in row) for row in m]
    return "\n".join(rows)


def _fmt(arg) -> str:
    if isinstance(arg, np.ndarray) or hasattr(arg, "shape"):
        a = np.asarray(arg)
        if a.shape == (3,):
            return format_vec3(a)
        if a.shape == (3, 3):
            return format_mat3(a)
        return str(a)
    return str(arg)


def log(level: LogLevel, *args, stream=None) -> None:
    if level == LogLevel.DEBUG and not _verbose:
        return
    stream = stream if stream is not None else sys.stdout
    ts = time.strftime("%H:%M:%S")
    prefix = f"[{level.name.capitalize()} {ts}] "
    msg = "".join(_fmt(a) for a in args)
    stream.write(f"{_COLORS[level]}{prefix}{msg}{_RESET}\n")
    stream.flush()


def debug(*args) -> None:
    log(LogLevel.DEBUG, *args)


def info(*args) -> None:
    log(LogLevel.INFO, *args)


def warning(*args) -> None:
    log(LogLevel.WARNING, *args)


def error(*args) -> None:
    log(LogLevel.ERROR, *args, stream=sys.stderr)
