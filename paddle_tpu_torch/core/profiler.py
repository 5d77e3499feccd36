"""In-process metrics registry and host annotations.

Port of the registry half of ``paddle_tpu.core.profiler``: monotonic
counters, last-value gauges and histograms (count, sum, min, max) that the
Trainer, the Executor, checkpointing and the resilience layer write, and
tests and scripts read. Labeled writes are summed into their family, as
the JAX package's flat ``counters()`` view does. ``record_event`` becomes
``torch.profiler.record_function``, so a region shows in a
``torch.profiler`` trace of the card. The JAX package's host span table,
Chrome-trace export and Prometheus exporter wait for the observability
slice (``ROADMAP.md``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional

import torch

__all__ = [
    "inc_counter", "set_gauge", "observe", "counters", "gauges", "histograms",
    "reset_metrics", "record_event",
]

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, Dict[str, float]] = {}


def inc_counter(name: str, value: float = 1.0, labels: Optional[dict] = None) -> None:
    """Add to a named monotonic counter (thread-safe)."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + float(value)


def set_gauge(name: str, value: float, labels: Optional[dict] = None) -> None:
    """Set a named gauge to its latest value (thread-safe)."""
    with _lock:
        _gauges[name] = float(value)


def observe(name: str, value: float, labels: Optional[dict] = None) -> None:
    """Record one observation into a named histogram (thread-safe)."""
    v = float(value)
    with _lock:
        h = _hists.setdefault(name, {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf})
        h["count"] += 1
        h["sum"] += v
        h["min"] = min(h["min"], v)
        h["max"] = max(h["max"], v)


def counters() -> Dict[str, float]:
    """Snapshot of all counters."""
    with _lock:
        return dict(_counters)


def gauges() -> Dict[str, float]:
    """Snapshot of all gauges (most recent write per name)."""
    with _lock:
        return dict(_gauges)


def histograms() -> Dict[str, Dict[str, float]]:
    """Snapshot of all histograms: ``{name: {count, sum, min, max}}``."""
    with _lock:
        return {k: dict(h) for k, h in _hists.items()}


def reset_metrics() -> None:
    """Clear counters, gauges and histograms (test isolation)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


@contextlib.contextmanager
def record_event(name: str) -> Iterator[None]:
    """Host annotation (RecordEvent parity): a named range in
    ``torch.profiler`` traces; costs one call when no profiler runs."""
    with torch.profiler.record_function(name):
        yield
