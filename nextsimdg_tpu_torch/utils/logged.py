"""Logging facade.

The port's copy of ``nextsimdg_tpu.utils.logged``: the reference's eight
syslog-style levels (``core/src/Logged.cpp:11-42``) on the stdlib
``logging`` module, under the logger ``nextsimdg_tpu_torch``.
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("nextsimdg_tpu_torch")

# Syslog-style levels (Logged.hpp:16).
_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "notice": logging.INFO + 1,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "alert": logging.CRITICAL + 1,
    "emergency": logging.CRITICAL + 2,
}
for _name, _value in _LEVELS.items():
    logging.addLevelName(_value, _name.upper())


class Logged:
    @staticmethod
    def log(message: str, level: str = "notice") -> None:
        _logger.log(_LEVELS.get(level, logging.INFO), message)

    @staticmethod
    def debug(message: str) -> None:
        _logger.log(_LEVELS["debug"], message)

    @staticmethod
    def info(message: str) -> None:
        _logger.log(_LEVELS["info"], message)

    @staticmethod
    def notice(message: str) -> None:
        _logger.log(_LEVELS["notice"], message)

    @staticmethod
    def warning(message: str) -> None:
        _logger.log(_LEVELS["warning"], message)

    @staticmethod
    def error(message: str) -> None:
        _logger.log(_LEVELS["error"], message)

    @staticmethod
    def critical(message: str) -> None:
        _logger.log(_LEVELS["critical"], message)

    @staticmethod
    def alert(message: str) -> None:
        _logger.log(_LEVELS["alert"], message)

    @staticmethod
    def emergency(message: str) -> None:
        _logger.log(_LEVELS["emergency"], message)
