"""Logging utilities.

Counterpart of ``mxnet_tpu/log.py`` (``get_logger``): a
level-colorized console formatter and a cached logger factory.
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger",
           "DEBUG", "INFO", "WARNING", "ERROR", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

_LEVEL_CHAR = {logging.DEBUG: "D", logging.INFO: "I",
               logging.WARNING: "W", logging.ERROR: "E",
               logging.CRITICAL: "C"}
_LEVEL_COLOR = {logging.WARNING: "\x1b[0;33m", logging.ERROR: "\x1b[0;31m",
                logging.CRITICAL: "\x1b[0;31m"}


class _Formatter(logging.Formatter):
    """``LEVEL mmdd hh:mm:ss name] message`` with ANSI colors on ttys."""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        char = _LEVEL_CHAR.get(record.levelno, "U")
        head = (f"{char} {self.formatTime(record, self.datefmt)} "
                f"{record.name}]")
        if self._colored and record.levelno in _LEVEL_COLOR:
            head = _LEVEL_COLOR[record.levelno] + head + "\x1b[0m"
        return f"{head} {record.getMessage()}"


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger with the framework formatter attached once."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mx_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        colored = False
    else:
        handler = logging.StreamHandler(sys.stderr)
        colored = getattr(sys.stderr, "isatty", lambda: False)()
    handler.setFormatter(_Formatter(colored=colored))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mx_init = True
    return logger


getLogger = get_logger
