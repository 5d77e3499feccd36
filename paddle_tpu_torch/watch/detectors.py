"""Online anomaly detectors: the shared math behind every "is this value
abnormal?" question in the stack.

Three detector shapes, all thread-safe, all pure (they decide, they never
report — alert emission lives in :mod:`paddle_tpu_torch.watch.alerts` and the
shells that own a detector, so one detector core serves the straggler
watch, the metric watcher, and tests without dragging I/O along):

* :class:`EwmaDetector` — exponentially-weighted mean/variance per key; an
  observation more than ``z_threshold`` standard deviations above the EWMA
  mean is anomalous. The right tool for smoothly-drifting series (step
  time, MFU) where the baseline must track slow change but reject spikes.
* :class:`RollingQuantileDetector` — a sliding window per key; an
  observation exceeding ``ratio`` × the window's ``q``-quantile is
  anomalous. Distribution-free, robust to heavy tails (queue depth,
  per-request latency).
* :class:`SkewDetector` — the spatial/temporal median-ratio core that
  :class:`paddle_tpu_torch.tracing.straggler.StragglerDetector` is built on:
  with ≥2 reporting keys a key's recent mean is compared against the
  median of all key means (spatial — one straggler cannot drag the
  baseline up and hide itself); with one key the latest observation is
  compared against that key's own recent median, excluding the latest
  (temporal — a spike cannot inflate its own baseline).

Every ``observe``/``record`` returns a :class:`DetectorResult` (or None
while the detector is still warming up) carrying the score, the baseline
it was computed against, and whether the observation was flagged.

A copy of ``paddle_tpu.watch.detectors`` for the PyTorch port.
"""

from __future__ import annotations

import math
import statistics
import threading
from collections import deque
from typing import Dict, Optional, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "DetectorResult",
    "EwmaDetector",
    "RollingQuantileDetector",
    "SkewDetector",
]


class DetectorResult:
    """One detector decision: ``flagged`` plus the evidence behind it.
    ``score`` is detector-specific (z-score, ratio-over-quantile, or skew
    ratio); ``baseline`` is what the observation was judged against."""

    __slots__ = ("flagged", "value", "score", "baseline", "mode")

    def __init__(self, flagged: bool, value: float, score: float,
                 baseline: float, mode: str):
        self.flagged = flagged
        self.value = value
        self.score = score
        self.baseline = baseline
        self.mode = mode

    def as_dict(self) -> dict:
        return {
            "flagged": self.flagged,
            "value": self.value,
            "score": round(self.score, 4),
            "baseline": round(self.baseline, 6),
            "mode": self.mode,
        }

    def __repr__(self):
        return (f"DetectorResult(flagged={self.flagged}, value={self.value}, "
                f"score={self.score:.3f}, baseline={self.baseline:.4g}, "
                f"mode={self.mode!r})")


class EwmaDetector:
    """EWMA mean + EWMA variance per key; flags z-scores above threshold.

    The variance update uses the standard exponentially-weighted form
    (West 1979): ``var <- (1-a) * (var + a * delta^2)`` — the same
    recurrence RiverML and telegraf use for online z-scoring. The first
    ``min_samples`` observations per key only train the baseline. An
    anomalous observation is (by default) NOT folded into the baseline —
    one spike must not teach the detector that spikes are normal — but
    persistently elevated values eventually are, via ``poison_after``
    consecutive flags (the series genuinely moved; re-learn it)."""

    def __init__(self, alpha: float = 0.3, z_threshold: float = 4.0,
                 min_samples: int = 5, min_spread: float = 1e-9,
                 poison_after: int = 8):
        enforce(0.0 < alpha <= 1.0, f"alpha must be in (0, 1], got {alpha}")
        enforce(z_threshold > 0, f"z_threshold must be > 0, got {z_threshold}")
        enforce(min_samples >= 2, f"min_samples must be >= 2, got {min_samples}")
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.min_spread = float(min_spread)
        self.poison_after = int(poison_after)
        self._lock = locks.Lock("watch.ewma_detector")
        # key -> [count, mean, var, consecutive_flags]
        self._state: Dict[str, list] = {}

    def observe(self, key: str, value: float) -> Optional[DetectorResult]:
        value = float(value)
        if not math.isfinite(value):
            return None
        with self._lock:
            st = self._state.get(key)
            if st is None:
                self._state[key] = [1, value, 0.0, 0]
                return None
            count, mean, var, streak = st
            if count < self.min_samples:
                self._absorb(st, value)
                return None
            # spread floor: a perfectly flat warmup series must not turn
            # every later sub-microsecond wobble into an alert
            std = math.sqrt(max(var, 0.0))
            spread = max(std, self.min_spread, abs(mean) * 1e-6)
            z = (value - mean) / spread
            flagged = z > self.z_threshold
            if flagged:
                st[3] = streak + 1
                if st[3] >= self.poison_after:
                    self._absorb(st, value)  # level shift: re-learn
            else:
                st[3] = 0
                self._absorb(st, value)
            return DetectorResult(flagged, value, z, mean, "ewma_z")

    def _absorb(self, st: list, value: float) -> None:
        count, mean, var, _ = st
        delta = value - mean
        incr = self.alpha * delta
        st[0] = count + 1
        st[1] = mean + incr
        st[2] = (1.0 - self.alpha) * (var + delta * incr)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                k: {"count": st[0], "mean": st[1],
                    "std": math.sqrt(max(st[2], 0.0)),
                    "consecutive_flags": st[3]}
                for k, st in self._state.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._state.clear()


class RollingQuantileDetector:
    """Sliding-window quantile baseline per key; flags observations above
    ``ratio`` × the window's ``q``-quantile. The flagged observation still
    enters the window (bounded memory keeps the baseline honest: a
    sustained shift becomes the new normal after one window)."""

    def __init__(self, window: int = 64, q: float = 0.9, ratio: float = 2.0,
                 min_samples: int = 8):
        enforce(window >= 4, f"window must be >= 4, got {window}")
        enforce(0.0 < q < 1.0, f"q must be in (0, 1), got {q}")
        enforce(ratio > 1.0, f"ratio must be > 1.0, got {ratio}")
        enforce(min_samples >= 2, f"min_samples must be >= 2, got {min_samples}")
        self.window = int(window)
        self.q = float(q)
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self._lock = locks.Lock("watch.quantile_detector")
        self._series: Dict[str, deque] = {}

    def observe(self, key: str, value: float) -> Optional[DetectorResult]:
        value = float(value)
        if not math.isfinite(value):
            return None
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = deque(maxlen=self.window)
            history = list(series)
            series.append(value)
        if len(history) < self.min_samples:
            return None
        baseline = _quantile(sorted(history), self.q)
        if baseline <= 0:
            return None
        score = value / baseline
        return DetectorResult(score > self.ratio, value, score, baseline,
                              "rolling_quantile")

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                k: {"count": len(s),
                    "baseline": _quantile(sorted(s), self.q) if s else 0.0}
                for k, s in self._series.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


def _quantile(sorted_values, q: float) -> float:
    """Linear-interpolation quantile on an already-sorted list."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_values[0])
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac)


class SkewDetector:
    """Spatial/temporal median-ratio skew — the straggler-detection core.

    ``record(key, seconds)`` returns a :class:`DetectorResult` whose
    ``score`` is the skew ratio and ``mode`` is ``"spatial"`` (≥2 keys
    with enough samples: this key's recent mean vs the median of all key
    means) or ``"temporal"`` (one key: latest vs its own recent median,
    excluding the latest). ``None`` while there is not enough signal.

    This is byte-for-byte the decision logic that used to live inside
    ``tracing.straggler.StragglerDetector``; the straggler shell now
    delegates here and keeps only the reporting (counter/gauge/runlog/
    warn-once)."""

    def __init__(self, ratio: float, window: int = 32, min_samples: int = 5):
        enforce(window >= 2, f"window must be >= 2, got {window}")
        enforce(min_samples >= 2, f"min_samples must be >= 2, got {min_samples}")
        self.ratio = float(ratio)
        enforce(self.ratio > 1.0,
                f"skew ratio must be > 1.0, got {self.ratio}")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._lock = locks.Lock("watch.skew_detector")
        self._series: Dict[str, deque] = {}

    def record(self, key: str, seconds: float) -> Optional[DetectorResult]:
        if seconds < 0:
            return None
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = deque(maxlen=self.window)
            series.append(float(seconds))
            skew, mode, baseline = self._skew_locked(key, float(seconds))
        if skew is None:
            return None
        return DetectorResult(skew > self.ratio, float(seconds), skew,
                              baseline, mode)

    def _skew_locked(self, key: str, latest: float
                     ) -> Tuple[Optional[float], str, float]:
        peers = {
            k: s for k, s in self._series.items() if len(s) >= self.min_samples
        }
        if len(peers) >= 2 and key in peers:
            # spatial: this key's recent mean against the median of all
            # keys' means — median (not mean) so one straggler cannot drag
            # the baseline up and hide itself.
            means = {k: sum(s) / len(s) for k, s in peers.items()}
            baseline = statistics.median(means.values())
            if baseline <= 0:
                return None, "spatial", 0.0
            return means[key] / baseline, "spatial", baseline
        series = self._series[key]
        if len(series) < self.min_samples:
            return None, "temporal", 0.0
        # temporal: the latest observation against this key's own recent
        # median (excluding the latest, so a spike cannot inflate its own
        # baseline).
        history = list(series)[:-1]
        baseline = statistics.median(history)
        if baseline <= 0:
            return None, "temporal", 0.0
        return latest / baseline, "temporal", baseline

    def window_stats(self) -> Dict[str, dict]:
        """Per-key window stats (count/mean/max)."""
        with self._lock:
            out = {}
            for k, s in self._series.items():
                vals = list(s)
                out[k] = {
                    "count": len(vals),
                    "mean_s": sum(vals) / len(vals) if vals else 0.0,
                    "max_s": max(vals) if vals else 0.0,
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
