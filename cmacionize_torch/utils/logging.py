"""Logging: a terminal (ANSI-colored) log and a null log, four levels.

Port of ``cmacionize_tpu/utils/logging.py`` (the reference's Log /
TerminalLog hierarchy, src/Log.hpp and src/TerminalLog.hpp).
"""

from __future__ import annotations

import sys
import time

LEVELS = {"info": 0, "status": 1, "warning": 2, "error": 3}
_COLORS = {"info": "", "status": "\033[1;32m", "warning": "\033[1;33m", "error": "\033[1;31m"}
_RESET = "\033[0m"


class Log:
    """Base log: filters on level, timestamps messages."""

    def __init__(self, level: str = "info"):
        self._threshold = LEVELS[level]
        self._start = time.time()

    def _emit(self, text: str, level: str) -> None:
        raise NotImplementedError

    def _write(self, message: str, level: str) -> None:
        if LEVELS[level] >= self._threshold:
            stamp = time.time() - self._start
            self._emit(f"[{stamp:10.3f}s] {message}", level)

    def info(self, message: str) -> None:
        self._write(message, "info")

    def status(self, message: str) -> None:
        self._write(message, "status")

    def warning(self, message: str) -> None:
        self._write(message, "warning")

    def error(self, message: str) -> None:
        self._write(message, "error")


class TerminalLog(Log):
    def __init__(self, level: str = "info", stream=None):
        super().__init__(level)
        self._stream = stream or sys.stderr
        self._color = hasattr(self._stream, "isatty") and self._stream.isatty()

    def _emit(self, text: str, level: str) -> None:
        if self._color and _COLORS[level]:
            text = f"{_COLORS[level]}{text}{_RESET}"
        print(text, file=self._stream, flush=True)


class NullLog(Log):
    def __init__(self):
        super().__init__("error")

    def _emit(self, text: str, level: str) -> None:
        pass
