"""Logger API (Whisper/API/loggerApi.h analogue).

A copy of ``whisper_tpu.obs.logging``, on its own logger
(``whisper_tpu_torch``).

Levels Error..Debug, a pluggable sink callback, stderr fallback — mapped
onto Python's logging so library code uses standard idioms while the public
surface mirrors the reference: ``setup_logger(level, sink, flags)``.
"""

from __future__ import annotations

import enum
import logging
import sys
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    DEBUG = 3


class LogFlags(enum.IntFlag):
    NONE = 0
    USE_STANDARD_ERROR = 1
    SKIP_FORMAT_MESSAGE = 2


_PY_LEVELS = {
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARNING: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.DEBUG: logging.DEBUG,
}

logger = logging.getLogger("whisper_tpu_torch")
_sink_handler: Optional[logging.Handler] = None


class _SinkHandler(logging.Handler):
    def __init__(self, sink: Callable[[int, str], None]):
        super().__init__()
        self.sink = sink

    def emit(self, record: logging.LogRecord) -> None:
        lvl = LogLevel.DEBUG
        if record.levelno >= logging.ERROR:
            lvl = LogLevel.ERROR
        elif record.levelno >= logging.WARNING:
            lvl = LogLevel.WARNING
        elif record.levelno >= logging.INFO:
            lvl = LogLevel.INFO
        self.sink(int(lvl), record.getMessage())


def setup_logger(
    level: LogLevel = LogLevel.INFO,
    sink: Optional[Callable[[int, str], None]] = None,
    flags: LogFlags = LogFlags.USE_STANDARD_ERROR,
) -> None:
    """setupLogger analogue: set verbosity and an optional message sink."""
    global _sink_handler
    logger.setLevel(_PY_LEVELS[LogLevel(level)])
    if _sink_handler is not None:
        logger.removeHandler(_sink_handler)
        _sink_handler = None
    if sink is not None:
        _sink_handler = _SinkHandler(sink)
        logger.addHandler(_sink_handler)
    if flags & LogFlags.USE_STANDARD_ERROR and not any(
        isinstance(h, logging.StreamHandler) and not isinstance(h, _SinkHandler)
        for h in logger.handlers
    ):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[whisper_tpu_torch] %(levelname)s: %(message)s"))
        logger.addHandler(h)
