"""Persistent perf baselines: rolling statistics per benchmark key,
serialized to disk, to fail a gate on regressions beyond a noise band
(a copy of ``paddle_tpu.watch.baseline``).

The store is keyed by ``(key, shape_bucket, dtype, device_kind)`` — the
same dimensions as the roofline ledger's keys, so a single
file can back both "did bench regress run-over-run?" and "which kernel
variant was fastest for this shape?". Each entry is a :class:`RollingStat`
(Welford count/mean/M2 plus min/max/last and an EMA that tracks drift),
updated from fresh ``bench.py`` JSON lines via :meth:`BaselineStore.update`
and judged via :meth:`BaselineStore.check`.

``check`` returns a verdict per metric:

* ``"new"``        — no baseline yet (never a failure; ``--update`` records it)
* ``"ok"``         — inside the noise band
* ``"improved"``   — outside the band in the good direction
* ``"regression"`` — outside the band in the bad direction

Direction comes from the metric name: throughput-shaped keys
(``*_per_sec``, ``mfu``, ``goodput_frac``) are higher-better; time-shaped
keys (``*_ms*``, ``*_seconds``, ``*_s``) are lower-better; anything else is
informational only. Saves are atomic (tmp + ``os.replace``) so a crashed
gate never leaves a torn store behind.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, Iterable, Optional, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "RollingStat",
    "BaselineStore",
    "BaselineKey",
    "metric_direction",
    "HIGHER_BETTER",
    "LOWER_BETTER",
    "INFO_ONLY",
]

STORE_VERSION = 1

HIGHER_BETTER = "higher_better"
LOWER_BETTER = "lower_better"
INFO_ONLY = "info"

_HIGHER_SUFFIXES = ("_per_sec", "_per_s", "_throughput", "_speedup")
_HIGHER_CONTAINS = ("_per_sec_", "_per_sec")  # e.g. decode_tok_per_sec_bs8
_HIGHER_EXACT = ("mfu", "goodput_frac", "handoff_quiet_throughput_frac",
                 "host_tier_prefix_hit_frac")
_LOWER_SUFFIXES = ("_seconds", "_ms", "_s", "_latency", "_overhead_pct")
_LOWER_CONTAINS = ("_ms_", "latency")


def metric_direction(name: str) -> str:
    """Classify a bench metric name: which way is 'worse'?"""
    low = name.lower()
    if (low in _HIGHER_EXACT or low.endswith(_HIGHER_SUFFIXES)
            or any(t in low for t in _HIGHER_CONTAINS)):
        return HIGHER_BETTER
    if low.endswith(_LOWER_SUFFIXES) or any(t in low for t in _LOWER_CONTAINS):
        return LOWER_BETTER
    return INFO_ONLY


class RollingStat:
    """Welford running stats plus min/max/last and a drift-tracking EMA."""

    __slots__ = ("count", "mean", "m2", "min", "max", "last", "ema")

    def __init__(self, count: int = 0, mean: float = 0.0, m2: float = 0.0,
                 min_v: float = math.inf, max_v: float = -math.inf,
                 last: float = 0.0, ema: float = 0.0):
        self.count = int(count)
        self.mean = float(mean)
        self.m2 = float(m2)
        self.min = float(min_v)
        self.max = float(max_v)
        self.last = float(last)
        self.ema = float(ema)

    def update(self, value: float, ema_alpha: float = 0.25) -> None:
        value = float(value)
        if not math.isfinite(value):
            return
        self.count += 1
        delta = value - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (value - self.mean)
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value
        self.ema = value if self.count == 1 else (
            (1.0 - ema_alpha) * self.ema + ema_alpha * value)

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self.m2 / (self.count - 1))

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "m2": self.m2,
            "min": self.min if math.isfinite(self.min) else None,
            "max": self.max if math.isfinite(self.max) else None,
            "last": self.last,
            "ema": self.ema,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RollingStat":
        return cls(
            count=d.get("count", 0),
            mean=d.get("mean", 0.0),
            m2=d.get("m2", 0.0),
            min_v=d["min"] if d.get("min") is not None else math.inf,
            max_v=d["max"] if d.get("max") is not None else -math.inf,
            last=d.get("last", 0.0),
            ema=d.get("ema", 0.0),
        )


class BaselineKey:
    """Composite key: (key, shape_bucket, dtype, device_kind), rendered as
    one store-file string ``key|shape_bucket|dtype|device_kind``."""

    SEP = "|"

    @classmethod
    def render(cls, key: str, shape_bucket: str = "-", dtype: str = "-",
               device_kind: str = "-") -> str:
        for part in (key, shape_bucket, dtype, device_kind):
            enforce(cls.SEP not in str(part),
                    f"baseline key part may not contain {cls.SEP!r}: {part!r}")
        return cls.SEP.join((key, shape_bucket, dtype, device_kind))

    @classmethod
    def parse(cls, rendered: str) -> Tuple[str, str, str, str]:
        parts = rendered.split(cls.SEP)
        enforce(len(parts) == 4, f"malformed baseline key {rendered!r}")
        return tuple(parts)  # type: ignore[return-value]


class BaselineStore:
    """Disk-backed map of rendered :class:`BaselineKey` -> :class:`RollingStat`.

    ``path=None`` keeps the store purely in-memory (unit tests, the
    autotuner's session-local cache). ``load`` tolerates a missing file;
    a malformed file raises — a corrupt baseline silently treated as empty
    would let every regression pass the gate."""

    def __init__(self, path: Optional[str] = None, ema_alpha: float = 0.25):
        self.path = path
        self.ema_alpha = float(ema_alpha)
        self._lock = locks.Lock("watch.baseline_store")
        self._stats: Dict[str, RollingStat] = {}
        if path and os.path.exists(path):
            self.load()

    def __len__(self) -> int:
        with self._lock:
            return len(self._stats)

    def keys(self) -> Iterable[str]:
        with self._lock:
            return list(self._stats.keys())

    def get(self, rendered_key: str) -> Optional[RollingStat]:
        with self._lock:
            return self._stats.get(rendered_key)

    def update(self, key: str, value: float, shape_bucket: str = "-",
               dtype: str = "-", device_kind: str = "-") -> RollingStat:
        rk = BaselineKey.render(key, shape_bucket, dtype, device_kind)
        with self._lock:
            st = self._stats.get(rk)
            if st is None:
                st = self._stats[rk] = RollingStat()
            st.update(value, self.ema_alpha)
            return st

    def check(self, key: str, value: float, shape_bucket: str = "-",
              dtype: str = "-", device_kind: str = "-",
              noise_band: float = 0.25,
              direction: Optional[str] = None) -> dict:
        """Judge ``value`` against the stored baseline.

        The comparison point is the EMA (drift-tracking) with the Welford
        std widening the band: tolerance = max(noise_band * |ema|, 2 * std).
        Returns {verdict, baseline, value, delta_frac, tolerance_frac,
        direction, samples}."""
        enforce(noise_band > 0, f"noise_band must be > 0, got {noise_band}")
        if direction is None:
            direction = metric_direction(key)
        rk = BaselineKey.render(key, shape_bucket, dtype, device_kind)
        with self._lock:
            st = self._stats.get(rk)
        out = {
            "key": rk,
            "value": float(value),
            "direction": direction,
            "noise_band": noise_band,
        }
        if st is None or st.count == 0:
            out.update(verdict="new", baseline=None, delta_frac=None,
                       samples=0)
            return out
        base = st.ema if st.ema else st.mean
        out["baseline"] = base
        out["samples"] = st.count
        if base == 0 or not math.isfinite(base):
            out.update(verdict="ok", delta_frac=None)
            return out
        delta_frac = (float(value) - base) / abs(base)
        tol_frac = max(noise_band, (2.0 * st.std) / abs(base))
        out["delta_frac"] = round(delta_frac, 6)
        out["tolerance_frac"] = round(tol_frac, 6)
        if direction == INFO_ONLY or abs(delta_frac) <= tol_frac:
            out["verdict"] = "ok"
        elif (delta_frac < 0) == (direction == LOWER_BETTER):
            out["verdict"] = "improved"
        else:
            out["verdict"] = "regression"
        return out

    # -- persistence -------------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write (tmp + rename) of the whole store."""
        path = path or self.path
        enforce(path, "BaselineStore.save needs a path")
        with self._lock:
            payload = {
                "version": STORE_VERSION,
                "ema_alpha": self.ema_alpha,
                "stats": {k: st.as_dict() for k, st in self._stats.items()},
            }
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def load(self, path: Optional[str] = None) -> None:
        path = path or self.path
        enforce(path, "BaselineStore.load needs a path")
        with open(path) as f:
            payload = json.load(f)
        enforce(isinstance(payload, dict) and "stats" in payload,
                f"malformed baseline store {path!r}")
        version = payload.get("version", 0)
        enforce(version <= STORE_VERSION,
                f"baseline store {path!r} has version {version}; "
                f"this build reads <= {STORE_VERSION}")
        stats = {k: RollingStat.from_dict(v)
                 for k, v in payload["stats"].items()}
        with self._lock:
            self._stats = stats
            if "ema_alpha" in payload:
                self.ema_alpha = float(payload["ema_alpha"])
