"""Leveled key/value logging (reference ``logger.go`` and
``pkg/statemachine/logger.go``).

The reference defines a minimal 4-level ``Logger`` interface —
``Log(level, text, ...kv)`` — with console implementations per threshold
(``logger.go:13-67``), duplicated in the statemachine package with an
adapter (``serializer.go:14-21``).  Here one Python protocol serves every
layer: components call ``debug/info/warn/error(text, **kv)``; anything with
those four methods (the stdlib ``logging`` module included, via
``StdlibAdapter``) plugs in.

Values render ``key=value`` with bytes hex-encoded, matching the
reference's console formatter (``logger.go:30-37``).
"""

from __future__ import annotations

import enum
import sys
from typing import Optional, Protocol, TextIO, runtime_checkable


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3


@runtime_checkable
class Logger(Protocol):
    """Minimal leveled kv logging interface (reference logger.go:62-67)."""

    def debug(self, text: str, **kv) -> None: ...

    def info(self, text: str, **kv) -> None: ...

    def warn(self, text: str, **kv) -> None: ...

    def error(self, text: str, **kv) -> None: ...


def _format_kv(kv: dict) -> str:
    parts = []
    for key, value in kv.items():
        if isinstance(value, (bytes, bytearray, memoryview)):
            parts.append(f" {key}={bytes(value).hex()}")
        else:
            parts.append(f" {key}={value}")
    return "".join(parts)


class ConsoleLogger:
    """Writes messages at or above ``level`` as one ``text k=v ...`` line
    (reference consoleLogger, logger.go:22-43)."""

    def __init__(self, level: LogLevel, stream: Optional[TextIO] = None):
        self.level = level
        self.stream = stream if stream is not None else sys.stdout

    def log(self, level: LogLevel, text: str, **kv) -> None:
        if level < self.level:
            return
        self.stream.write(
            f"{LogLevel(level).name:5s} {text}{_format_kv(kv)}\n"
        )

    def debug(self, text: str, **kv) -> None:
        self.log(LogLevel.DEBUG, text, **kv)

    def info(self, text: str, **kv) -> None:
        self.log(LogLevel.INFO, text, **kv)

    def warn(self, text: str, **kv) -> None:
        self.log(LogLevel.WARN, text, **kv)

    def error(self, text: str, **kv) -> None:
        self.log(LogLevel.ERROR, text, **kv)


class PrefixLogger:
    """Wraps a logger, stamping fixed key/value context (e.g. ``node=3``)
    onto every message — the statemachine adapter of the reference
    (``pkg/statemachine/serializer.go:14-21``) specialized to kv context."""

    def __init__(self, inner: Logger, **context):
        self.inner = inner
        self.context = context

    def _merged(self, kv: dict) -> dict:
        merged = dict(self.context)
        merged.update(kv)
        return merged

    def debug(self, text: str, **kv) -> None:
        self.inner.debug(text, **self._merged(kv))

    def info(self, text: str, **kv) -> None:
        self.inner.info(text, **self._merged(kv))

    def warn(self, text: str, **kv) -> None:
        self.inner.warn(text, **self._merged(kv))

    def error(self, text: str, **kv) -> None:
        self.inner.error(text, **self._merged(kv))


class StdlibAdapter:
    """Adapts a stdlib ``logging.Logger`` to the kv interface."""

    def __init__(self, inner):
        self.inner = inner

    @staticmethod
    def _line(text: str, kv: dict) -> str:
        return f"{text}{_format_kv(kv)}"

    def debug(self, text: str, **kv) -> None:
        self.inner.debug(self._line(text, kv))

    def info(self, text: str, **kv) -> None:
        self.inner.info(self._line(text, kv))

    def warn(self, text: str, **kv) -> None:
        self.inner.warning(self._line(text, kv))

    def error(self, text: str, **kv) -> None:
        self.inner.error(self._line(text, kv))


# Console singletons per threshold (reference logger.go:45-59).
console_debug_logger = ConsoleLogger(LogLevel.DEBUG)
console_info_logger = ConsoleLogger(LogLevel.INFO)
console_warn_logger = ConsoleLogger(LogLevel.WARN)
console_error_logger = ConsoleLogger(LogLevel.ERROR)
