"""Straggler detection over per-replica / per-step durations.

A copy of ``paddle_tpu.tracing.straggler``. Across cards one slow
participant sets the pace for everyone: a serving
replica with a flaky host drags every batch routed to it, a device whose
steps degrade throttles the whole data-parallel step (GDP, arxiv
1910.01578, builds its placement decisions on exactly this per-device
timing attribution). The detector consumes the same durations the tracing
spans measure and flags two shapes of skew:

* **spatial** — several keys report the same kind of duration (one per
  serving replica): a key whose recent mean exceeds the median of all key
  means by ``ratio`` is a straggler relative to its peers.
* **temporal** — only one key reports (a single-host trainer's step time):
  an observation exceeding the key's own recent median by ``ratio`` is a
  straggler relative to its past.

The decision math lives in the shared
:class:`paddle_tpu_torch.watch.detectors.SkewDetector` core (so the metric
watcher, tests, and this shell all agree on what "skewed" means); this
module keeps the reporting. Flags are exported three ways so every
consumer sees them: a ``tracing.straggler.flags_total`` counter and
``tracing.straggler.skew_ratio`` gauge (labeled group/key), a runlog
``straggler`` event (which carries the active trace ids when flagged
inside a span), and a ``warn_once`` log line per (group, key).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.config import flags
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.watch.detectors import SkewDetector

__all__ = ["StragglerDetector"]


class StragglerDetector:
    """Sliding-window skew detector. ``record(key, seconds)`` returns True
    when that observation was flagged. Thread-safe — serving worker threads
    record concurrently."""

    def __init__(
        self,
        group: str,
        ratio: Optional[float] = None,
        window: int = 32,
        min_samples: int = 5,
    ):
        self.group = group
        self._core = SkewDetector(
            ratio=float(ratio if ratio is not None else flags().straggler_ratio),
            window=window,
            min_samples=min_samples,
        )
        self.flagged: Dict[str, int] = {}  # key -> flag count
        self._lock = locks.Lock("tracing.straggler")

    @property
    def ratio(self) -> float:
        return self._core.ratio

    @property
    def window(self) -> int:
        return self._core.window

    @property
    def min_samples(self) -> int:
        return self._core.min_samples

    def record(self, key: str, seconds: float) -> bool:
        """Record one duration for ``key``; returns True if it was flagged
        as a straggler."""
        result = self._core.record(key, seconds)
        if result is None or not result.flagged:
            return False
        self._flag(key, seconds, result.score, result.mode)
        return True

    def _flag(self, key: str, seconds: float, skew: float, mode: str) -> None:
        with self._lock:
            self.flagged[key] = self.flagged.get(key, 0) + 1
        labels = {"group": self.group, "key": key}
        prof.inc_counter("tracing.straggler.flags_total", labels=labels)
        prof.set_gauge("tracing.straggler.skew_ratio", round(skew, 4), labels=labels)
        runlog.emit(
            "straggler",
            group=self.group,
            key=key,
            mode=mode,
            seconds=round(seconds, 6),
            skew_ratio=round(skew, 4),
            threshold=self.ratio,
        )
        ptlog.warn_once(
            f"straggler[{self.group}/{key}]",
            "straggler detected: %s %s took %.4fs — %.2fx the %s baseline "
            "(threshold %.2fx)",
            self.group, key, seconds, skew, mode, self.ratio,
        )

    def snapshot(self) -> Dict[str, dict]:
        """Per-key window stats (count/mean/max) plus flag counts."""
        out = self._core.window_stats()
        with self._lock:
            for k, stats in out.items():
                stats["flags"] = self.flagged.get(k, 0)
        return out
