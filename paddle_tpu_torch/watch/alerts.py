"""Alert fan-out: one structured record per anomaly/SLO violation, exported
every way an operator (or another subsystem) might consume it.

An :class:`Alert` emitted through the :class:`AlertHub` lands in four
places at once:

- the bounded in-memory store the exporter's ``/alerts`` endpoint serves;
- a ``watch.alert.events_total`` counter (labeled source/severity) and
  ``watch.alert.last_ts`` gauge in the metric registry, so alert volume is
  itself scrapeable and dashboards can alert on the alerting;
- an ``alert`` runlog event (which inherits the active trace ids when
  emitted inside a span, like every other runlog line);
- a ``warn_once`` log line per (source, key) — the console stays readable
  while a sick replica fires the same alert every batch.

Registered *actions* (``register_action``) run synchronously on every
emit — this is the hook the serving engine uses to let a latency-anomaly
alert trip a replica's circuit breaker (``resilience.circuit``). Action
exceptions are swallowed and counted (``watch.alert.action_errors_total``):
a broken handler must never take down the path that detected the problem.

A copy of ``paddle_tpu.watch.alerts`` for the PyTorch port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.observability import runlog

__all__ = ["Alert", "AlertHub", "default_hub", "WARNING", "CRITICAL"]

WARNING = "warning"
CRITICAL = "critical"


class Alert:
    """One detected anomaly or SLO violation."""

    __slots__ = ("ts", "source", "key", "severity", "message", "value",
                 "baseline", "score", "labels")

    def __init__(self, source: str, key: str, message: str,
                 severity: str = WARNING, value: float = 0.0,
                 baseline: float = 0.0, score: float = 0.0,
                 labels: Optional[Dict[str, str]] = None,
                 ts: Optional[float] = None):
        self.ts = time.time() if ts is None else float(ts)
        self.source = source        # e.g. "watch.step_time", "slo.serving_p99"
        self.key = key              # e.g. "replica2", "step", the SLO name
        self.severity = severity
        self.message = message
        self.value = float(value)
        self.baseline = float(baseline)
        self.score = float(score)
        self.labels = dict(labels or {})

    def as_dict(self) -> dict:
        return {
            "ts": self.ts,
            "source": self.source,
            "key": self.key,
            "severity": self.severity,
            "message": self.message,
            "value": self.value,
            "baseline": self.baseline,
            "score": round(self.score, 4),
            "labels": self.labels,
        }

    def __repr__(self):
        return (f"Alert({self.source!r}, {self.key!r}, {self.severity}, "
                f"value={self.value:.4g}, score={self.score:.3f})")


class AlertHub:
    """Thread-safe bounded alert store + fan-out (see module docstring)."""

    def __init__(self, capacity: int = 1024):
        self._lock = locks.Lock("watch.alert_hub")
        self._alerts: deque = deque(maxlen=capacity)
        self._actions: List[Callable[[Alert], None]] = []
        self.emitted_total = 0

    def emit(self, alert: Alert) -> Alert:
        with self._lock:
            self._alerts.append(alert)
            self.emitted_total += 1
            actions = tuple(self._actions)
        labels = {"source": alert.source, "severity": alert.severity}
        prof.inc_counter("watch.alert.events_total", labels=labels)
        prof.set_gauge("watch.alert.last_ts", alert.ts, labels=labels)
        runlog.emit(
            "alert",
            source=alert.source,
            key=alert.key,
            severity=alert.severity,
            message=alert.message,
            value=round(alert.value, 6),
            baseline=round(alert.baseline, 6),
            score=round(alert.score, 4),
            **alert.labels,
        )
        ptlog.warn_once(
            ("watch-alert", alert.source, alert.key),
            "ALERT [%s/%s] %s: %s (value=%.4g baseline=%.4g score=%.2f)",
            alert.source, alert.severity, alert.key, alert.message,
            alert.value, alert.baseline, alert.score,
        )
        for action in actions:
            try:
                action(alert)
            except Exception as e:  # a broken handler must not mask detection
                prof.inc_counter("watch.alert.action_errors_total")
                ptlog.error("alert action %r failed: %r", action, e)
        return alert

    def register_action(self, action: Callable[[Alert], None]) -> None:
        """Run ``action(alert)`` synchronously on every future emit."""
        with self._lock:
            self._actions.append(action)

    def unregister_action(self, action: Callable[[Alert], None]) -> None:
        with self._lock:
            if action in self._actions:
                self._actions.remove(action)

    def alerts(self, n: Optional[int] = None,
               source: Optional[str] = None) -> List[Alert]:
        """Most recent ``n`` alerts (all when None), newest last."""
        with self._lock:
            items = list(self._alerts)
        if source is not None:
            items = [a for a in items if a.source == source]
        return items[-n:] if n else items

    def clear(self) -> None:
        """Drop stored alerts and actions (test isolation)."""
        with self._lock:
            self._alerts.clear()
            self._actions.clear()
            self.emitted_total = 0


_default = AlertHub()


def default_hub() -> AlertHub:
    """The process-wide hub the exporter's ``/alerts`` endpoint serves."""
    return _default
