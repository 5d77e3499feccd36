"""Typed, labeled metric registry: counters, gauges, and histograms.

A copy of ``paddle_tpu.observability.metrics`` (jax-free) for the PyTorch
port. Every metric belongs to a typed *family* (one name, one kind, one
help string, one label schema) holding one child per label-value
combination — the same data model Prometheus scrapes. The serving layer
(``serving/metrics.py``, ``serving/admission.py``) writes here; the port's
``core.profiler`` keeps its own flat counters, and the exporter that
renders this registry is not ported yet.

Naming convention: ``subsystem.snake_case``, e.g.
``serving.decode.steps_total`` or ``serving.decode.ttft_seconds``.

Histograms store per-bucket (non-cumulative) observation counts plus a
running sum; :meth:`MetricRegistry.collect` cumulates them. Bucket edges are fixed at family creation — declare
non-default edges up front with :meth:`MetricRegistry.histogram`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import enforce

__all__ = [
    "COUNTER",
    "GAUGE",
    "HISTOGRAM",
    "DEFAULT_BUCKETS",
    "MetricRegistry",
    "FamilySnapshot",
    "default_registry",
    "exponential_buckets",
    "linear_buckets",
    "histogram_quantile",
]

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Latency-flavored default edges (seconds), ~Prometheus client defaults.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelTuple = Tuple[Tuple[str, str], ...]


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` edges starting at ``start``, each ``factor``× the last."""
    enforce.enforce(start > 0, "exponential_buckets: start must be > 0")
    enforce.enforce(factor > 1, "exponential_buckets: factor must be > 1")
    enforce.enforce(count > 0, "exponential_buckets: count must be > 0")
    edges, edge = [], float(start)
    for _ in range(count):
        edges.append(edge)
        edge *= factor
    return tuple(edges)


def linear_buckets(start: float, width: float, count: int) -> Tuple[float, ...]:
    """``count`` evenly spaced edges: start, start+width, ..."""
    enforce.enforce(width > 0, "linear_buckets: width must be > 0")
    enforce.enforce(count > 0, "linear_buckets: count must be > 0")
    return tuple(float(start) + float(width) * i for i in range(count))


def histogram_quantile(edges: Sequence[float], cumulative: Sequence[int],
                       count: int, q: float) -> float:
    """Estimate the ``q``-quantile (0 < q < 1) of a histogram from its
    cumulative bucket counts, interpolating linearly WITHIN the bucket that
    holds the target rank — the same estimator as PromQL's
    ``histogram_quantile``, so the value an SLO engine computes offline
    matches what a dashboard shows. Ranks landing above the last finite
    edge (the +Inf bucket) clamp to that edge: the histogram carries no
    upper bound to interpolate toward. Returns 0.0 for an empty histogram.
    """
    enforce.enforce(0.0 < q < 1.0, f"quantile q must be in (0, 1), got {q}")
    if count <= 0 or not edges:
        return 0.0
    rank = q * count
    prev_cum = 0
    for i, edge in enumerate(edges):
        cum = cumulative[i]
        if cum >= rank:
            lo = 0.0 if i == 0 else float(edges[i - 1])
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return float(edge)
            frac = (rank - prev_cum) / in_bucket
            return lo + (float(edge) - lo) * frac
        prev_cum = cum
    return float(edges[-1])  # rank in the +Inf overflow bucket: clamp


def _canon_labels(labels: Optional[Dict[str, str]]) -> LabelTuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Hist:
    """One histogram child: per-bucket counts + overflow + sum."""

    __slots__ = ("bucket_counts", "overflow", "total", "count")

    def __init__(self, n_edges: int):
        self.bucket_counts = [0] * n_edges
        self.overflow = 0          # observations above the last edge
        self.total = 0.0           # sum of observed values
        self.count = 0

    def observe(self, edges: Sequence[float], value: float) -> None:
        idx = bisect.bisect_left(edges, value)
        if idx < len(edges):
            self.bucket_counts[idx] += 1
        else:
            self.overflow += 1
        self.total += value
        self.count += 1

    def cumulative(self) -> List[int]:
        out, running = [], 0
        for c in self.bucket_counts:
            running += c
            out.append(running)
        return out


class _Family:
    __slots__ = ("name", "kind", "help", "label_names", "buckets",
                 "children", "last_labels")

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.label_names: Optional[Tuple[str, ...]] = None
        self.buckets = buckets
        # label tuple -> float (counter/gauge) or _Hist
        self.children: Dict[LabelTuple, object] = {}
        self.last_labels: LabelTuple = ()  # most recently written child


class FamilySnapshot:
    """Immutable view of one family for exporters/tests."""

    __slots__ = ("name", "kind", "help", "buckets", "samples")

    def __init__(self, name, kind, help_text, buckets, samples):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        # counter/gauge: [(labels_tuple, float)]
        # histogram: [(labels_tuple, {"cumulative": [...], "sum": s, "count": n})]
        self.samples = samples


class MetricRegistry:
    """Thread-safe registry of typed metric families."""

    def __init__(self):
        self._lock = locks.Lock("observability.metric_registry")
        self._families: Dict[str, _Family] = {}

    # -- declaration -------------------------------------------------------

    def counter(self, name: str, help: str = "") -> None:
        with self._lock:
            self._family(name, COUNTER, help)

    def gauge(self, name: str, help: str = "") -> None:
        with self._lock:
            self._family(name, GAUGE, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> None:
        """Declare a histogram family; ``buckets`` are upper edges (sorted
        ascending, ``+Inf`` implicit). Edges are frozen on first declaration."""
        edges = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        enforce.enforce_eq(list(edges), sorted(set(edges)),
                           f"histogram {name!r}: bucket edges must be "
                           f"strictly increasing, got {edges}")
        with self._lock:
            self._family(name, HISTOGRAM, help, buckets=edges)

    def _family(self, name: str, kind: str, help_text: str,
                buckets: Optional[Tuple[float, ...]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help_text, buckets=buckets)
            self._families[name] = fam
        else:
            enforce.enforce_eq(
                fam.kind, kind,
                f"metric {name!r} already registered as {fam.kind}, "
                f"cannot use as {kind}")
            if help_text and not fam.help:
                fam.help = help_text
        return fam

    def _child_key(self, fam: _Family, labels: Optional[Dict[str, str]]) -> LabelTuple:
        key = _canon_labels(labels)
        names = tuple(k for k, _ in key)
        if fam.label_names is None:
            fam.label_names = names
        else:
            enforce.enforce_eq(
                fam.label_names, names,
                f"metric {fam.name!r}: inconsistent label names "
                f"{names} vs {fam.label_names}")
        fam.last_labels = key
        return key

    # -- writes ------------------------------------------------------------

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None, help: str = "") -> None:
        with self._lock:
            fam = self._family(name, COUNTER, help)
            key = self._child_key(fam, labels)
            fam.children[key] = fam.children.get(key, 0.0) + value

    def set(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None, help: str = "") -> None:
        with self._lock:
            fam = self._family(name, GAUGE, help)
            key = self._child_key(fam, labels)
            fam.children[key] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None, help: str = "") -> None:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._family(name, HISTOGRAM, help,
                                   buckets=DEFAULT_BUCKETS)
            else:
                enforce.enforce_eq(
                    fam.kind, HISTOGRAM,
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot use as {HISTOGRAM}")
            key = self._child_key(fam, labels)
            child = fam.children.get(key)
            if child is None:
                child = _Hist(len(fam.buckets))
                fam.children[key] = child
            child.observe(fam.buckets, float(value))

    # -- reads -------------------------------------------------------------

    def collect(self) -> List[FamilySnapshot]:
        """Point-in-time snapshot of every family, sorted by name."""
        with self._lock:
            out = []
            for name in sorted(self._families):
                fam = self._families[name]
                samples = []
                for key in sorted(fam.children):
                    child = fam.children[key]
                    if fam.kind == HISTOGRAM:
                        samples.append((key, {
                            "cumulative": child.cumulative(),
                            "overflow": child.overflow,
                            "sum": child.total,
                            "count": child.count,
                        }))
                    else:
                        samples.append((key, float(child)))
                out.append(FamilySnapshot(fam.name, fam.kind, fam.help,
                                          fam.buckets, samples))
            return out

    def flat_counters(self) -> Dict[str, float]:
        """Legacy flat view: labeled children summed under the bare name."""
        with self._lock:
            out = {}
            for name, fam in self._families.items():
                if fam.kind == COUNTER and fam.children:
                    out[name] = float(sum(fam.children.values()))
            return out

    def flat_gauges(self) -> Dict[str, float]:
        """Legacy flat view: the most recently written child per family
        (matches the old colliding-write behavior for labeled gauges)."""
        with self._lock:
            out = {}
            for name, fam in self._families.items():
                if fam.kind == GAUGE and fam.children:
                    key = (fam.last_labels if fam.last_labels in fam.children
                           else next(iter(fam.children)))
                    out[name] = float(fam.children[key])
            return out

    def get(self, name: str, labels: Optional[Dict[str, str]] = None,
            default: Optional[float] = 0.0) -> Optional[float]:
        """Read one counter/gauge child. ``default`` (0.0) is returned when
        the family or child is absent — pass ``default=None`` to tell
        "never written" apart from a real 0.0 (the SLO engine does, so a
        gauge-bound objective cannot judge a gauge that does not exist yet)."""
        key = _canon_labels(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind == HISTOGRAM:
                return default
            child = fam.children.get(key)
            return default if child is None else float(child)

    def histogram_snapshot(self, name: str,
                           labels: Optional[Dict[str, str]] = None) -> Optional[dict]:
        """One histogram child as {edges, cumulative, sum, count}."""
        key = _canon_labels(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != HISTOGRAM:
                return None
            child = fam.children.get(key)
            if child is None:
                return None
            cum = child.cumulative()
            return {
                "edges": list(fam.buckets),
                "cumulative": cum,
                "sum": child.total,
                "count": child.count,
            }

    def quantile(self, name: str, q: float,
                 labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Estimated ``q``-quantile of one histogram child via linear
        interpolation within buckets (:func:`histogram_quantile`). ``None``
        when the family/child is absent or empty — callers distinguish "no
        data yet" from a real 0.0 observation."""
        snap = self.histogram_snapshot(name, labels)
        if snap is None or snap["count"] <= 0:
            return None
        return histogram_quantile(
            snap["edges"], snap["cumulative"], snap["count"], q)

    def reset(self) -> None:
        """Drop every family (test isolation)."""
        with self._lock:
            self._families.clear()


_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    """The process-wide registry every subsystem writes into."""
    return _default

