"""Logging — replacement for glog VLOG / pretty_log.

Maps to stdlib logging with a VLOG-style verbosity gate controlled by the
``v`` flag. Same surface as ``paddle_tpu.core.logging``; the dedup set of
:func:`warn_once` is guarded by the named ``core.locks`` lock
``core.warn_once``, as in the JAX package.
"""

from __future__ import annotations

import logging
import sys

from paddle_tpu_torch.core import locks

_logger = logging.getLogger("paddle_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s paddle_tpu_torch] %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def get_logger() -> logging.Logger:
    return _logger


def vlog(level: int, msg: str, *args) -> None:
    """VLOG(level): emitted when flags().v >= level."""
    from paddle_tpu_torch.core import config

    if config.flags().v >= level:
        _logger.info(msg, *args)


def info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


_warned_once: set = set()
_warned_once_lock = locks.Lock("core.warn_once")


def warn_once(key, msg: str, *args) -> bool:
    """Emit ``warning(msg, *args)`` only the first time ``key`` is seen.
    Returns True when the warning was actually emitted."""
    with _warned_once_lock:
        if key in _warned_once:
            return False
        _warned_once.add(key)
    _logger.warning(msg, *args)
    return True


def reset_warn_once() -> None:
    """Clear the warn_once dedup set (tests)."""
    with _warned_once_lock:
        _warned_once.clear()


def error(msg: str, *args) -> None:
    _logger.error(msg, *args)
