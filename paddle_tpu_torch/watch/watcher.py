"""Metric watching: subscribe anomaly detectors to live registry writes.

A :class:`WatchRule` binds one metric family to one detector: every write
to that family (`registry.subscribe`) is forwarded as
``detector.observe(key, value)`` where ``key`` is derived from the write's
labels (by default the sorted ``k=v`` join, so per-replica serving series
stay separate). A flagged :class:`DetectorResult` becomes an
:class:`~paddle_tpu_torch.watch.alerts.Alert` through the hub — runlog event,
``watch.alert.*`` counters, warn-once log, ``/alerts``, registered actions.

The :class:`MetricWatcher` holds the rules, one registry subscription, and
an optional :class:`~paddle_tpu_torch.watch.slo.SloEngine` it ticks (rate-limited)
on every write so SLO evaluation needs no extra thread. Re-entrancy is
handled with a thread-local guard: emitting an alert writes
``watch.alert.*`` counters, which re-notify subscribers — the guard makes
the nested notification a no-op instead of a recursion. ``watch.*``
families are never watched for the same reason.

:func:`default_rules` encodes the stack's standing watches (trainer step
time, serving per-replica latency, queue depth, MFU floor) so
``WatchConfig(enabled=True)`` is useful with zero per-metric setup.

A copy of ``paddle_tpu.watch.watcher`` for the PyTorch port.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.watch import alerts as alerts_mod
from paddle_tpu_torch.watch import detectors as det_mod
from paddle_tpu_torch.watch import slo as slo_mod

__all__ = ["WatchRule", "WatchConfig", "MetricWatcher", "default_rules"]


def _default_key(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return "-"
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class WatchRule:
    """Watch one metric family with one detector.

    ``invert=True`` watches for anomalously LOW values (MFU, goodput) by
    feeding the detector the negated series — a drop becomes a spike."""

    def __init__(self, metric: str, detector, source: Optional[str] = None,
                 key_fn: Callable[[Optional[Dict[str, str]]], str] = _default_key,
                 severity: str = alerts_mod.WARNING,
                 invert: bool = False,
                 kinds: tuple = (obs_metrics.HISTOGRAM, obs_metrics.GAUGE)):
        self.metric = metric
        self.detector = detector
        self.source = source or f"watch.{metric}"
        self.key_fn = key_fn
        self.severity = severity
        self.invert = invert
        self.kinds = kinds

    def feed(self, value: float, labels: Optional[Dict[str, str]],
             hub: alerts_mod.AlertHub) -> Optional[det_mod.DetectorResult]:
        key = self.key_fn(labels)
        fed = -value if self.invert else value
        observe = getattr(self.detector, "observe", None) or self.detector.record
        result = observe(key, fed)
        if result is not None and result.flagged:
            shown = -result.value if self.invert else result.value
            baseline = -result.baseline if self.invert else result.baseline
            hub.emit(alerts_mod.Alert(
                source=self.source,
                key=key,
                severity=self.severity,
                message=(f"{self.metric} anomalous: value={shown:.6g} "
                         f"baseline={baseline:.6g} score={result.score:.3f} "
                         f"({result.mode})"),
                value=shown,
                baseline=baseline,
                score=result.score,
                labels=dict(labels or {}),
            ))
        return result


@dataclass
class WatchConfig:
    """Attachment config for trainer/serving: which watches to run."""

    enabled: bool = False
    rules: List[WatchRule] = field(default_factory=list)
    use_default_rules: bool = True
    slos: List[slo_mod.SLO] = field(default_factory=list)
    hub: Optional[alerts_mod.AlertHub] = None


def default_rules() -> List[WatchRule]:
    """The stack's standing watches. Conservative thresholds: these run in
    production paths, so false-positive cost dominates."""
    return [
        WatchRule("trainer.step_seconds",
                  det_mod.EwmaDetector(alpha=0.25, z_threshold=6.0,
                                       min_samples=8)),
        WatchRule("serving.request_latency_seconds",
                  det_mod.RollingQuantileDetector(window=128, q=0.9,
                                                  ratio=3.0, min_samples=16)),
        WatchRule("serving.replica_exec_seconds",
                  det_mod.RollingQuantileDetector(window=64, q=0.9,
                                                  ratio=3.0, min_samples=8)),
        WatchRule("serving.queue_depth",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=8.0,
                                       min_samples=16)),
        WatchRule("trainer.mfu",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=6.0,
                                       min_samples=8),
                  invert=True),
        # decode engines reset this gauge to 0 on every clean iteration,
        # so a sustained climb means an engine is in a quarantine loop
        # and about to trip its breaker / migrate its requests
        WatchRule("serving.recovery.consecutive_faults",
                  det_mod.EwmaDetector(alpha=0.3, z_threshold=6.0,
                                       min_samples=8)),
        # cumulative draft-acceptance ratio under speculative decoding: a
        # collapse (inverted — anomalously LOW) means the draft has
        # diverged from the target (stale draft weights, wrong tokenizer)
        # and every verify step is wasted work
        WatchRule("serving.decode.spec_accept_rate",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=6.0,
                                       min_samples=16),
                  invert=True),
        # per-token latency (TPOT), inverted: the HIGH side is covered by
        # the slo.decode_token_slos burn-rate objectives, so the standing
        # watch guards the too-good-to-be-true side — an anomalous TPOT
        # collapse means tokens are landing implausibly fast (degenerate
        # speculation acceptance, a truncated decode loop booking
        # near-zero iteration gaps), i.e. the engine is probably not
        # doing the work the numbers claim
        WatchRule("serving.decode.tpot_seconds",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=8.0,
                                       min_samples=32),
                  invert=True),
        # disaggregated serving (serving.disagg): per-engine backlog and
        # live load. A sustained spike on a prefill-role worker is the
        # queue-depth anomaly signal the Autoscaler's scale_prefill rule
        # consumes (alongside the decode-p99 SLO burn rate)
        WatchRule("serving.decode.queue_depth",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=8.0,
                                       min_samples=16)),
        WatchRule("serving.decode.load",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=8.0,
                                       min_samples=16)),
        # hierarchical KV host tier (serving.host_tier): cumulative count
        # of demotes that forced an LRU eviction from the host pool. A
        # sustained climb means the fleet's warm prefix working set no
        # longer fits host RAM — promote hit rate is about to decay and
        # the tier budget needs raising
        WatchRule("serving.host_tier.demote_backpressure",
                  det_mod.EwmaDetector(alpha=0.2, z_threshold=8.0,
                                       min_samples=16)),
    ]


class MetricWatcher:
    """One registry subscription fanning writes out to the rules."""

    def __init__(self, registry: Optional[obs_metrics.MetricRegistry] = None,
                 hub: Optional[alerts_mod.AlertHub] = None,
                 rules: Optional[List[WatchRule]] = None,
                 slo_engine: Optional[slo_mod.SloEngine] = None):
        self.registry = registry or obs_metrics.default_registry()
        self.hub = hub or alerts_mod.default_hub()
        self.slo_engine = slo_engine
        self._lock = locks.Lock("watch.metric_watcher")
        self._rules: Dict[str, List[WatchRule]] = {}
        self._tls = threading.local()
        self._subscribed = False
        for rule in rules or []:
            self.add_rule(rule)

    def add_rule(self, rule: WatchRule) -> "MetricWatcher":
        if rule.metric.startswith("watch."):
            # watching our own output would alert on alerting
            ptlog.warn_once(("watch-self", rule.metric),
                            "refusing to watch watch.* family %s", rule.metric)
            return self
        with self._lock:
            self._rules.setdefault(rule.metric, []).append(rule)
        return self

    @property
    def rules(self) -> List[WatchRule]:
        with self._lock:
            return [r for rs in self._rules.values() for r in rs]

    def start(self) -> "MetricWatcher":
        with self._lock:
            if not self._subscribed:
                self.registry.subscribe(self._on_write)
                self._subscribed = True
        return self

    def close(self) -> None:
        with self._lock:
            if self._subscribed:
                self.registry.unsubscribe(self._on_write)
                self._subscribed = False

    # -- the subscription callback ----------------------------------------

    def _on_write(self, name: str, kind: str, value: float,
                  labels: Optional[Dict[str, str]]) -> None:
        if getattr(self._tls, "busy", False):
            return  # nested write from our own alert/SLO emission
        if name.startswith("watch."):
            return
        self._tls.busy = True
        try:
            with self._lock:
                rules = tuple(self._rules.get(name, ()))
            for rule in rules:
                if kind not in rule.kinds:
                    continue
                rule.feed(value, labels, self.hub)
            if self.slo_engine is not None:
                self.slo_engine.tick()
        finally:
            self._tls.busy = False


def build(config: WatchConfig,
          registry: Optional[obs_metrics.MetricRegistry] = None
          ) -> Optional[MetricWatcher]:
    """Construct-and-start a watcher from a :class:`WatchConfig` (the
    trainer/serving attachment point). Returns None when disabled."""
    if not config.enabled:
        return None
    rules = list(config.rules)
    if config.use_default_rules:
        rules.extend(default_rules())
    engine = None
    if config.slos:
        engine = slo_mod.SloEngine(registry=registry, hub=config.hub)
        for s in config.slos:
            engine.add(s)
        slo_mod.install(engine)
    watcher = MetricWatcher(registry=registry, hub=config.hub,
                            rules=rules, slo_engine=engine)
    return watcher.start()
