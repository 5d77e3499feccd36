"""Fleet telemetry rollup: the fleet observable as one system — port of
``paddle_tpu.observability.fleet``.

Every ``DecodeMetrics`` publishes ``engine=``-labeled families into the
process registry; a :class:`FleetView` reads across them. It wraps a
:class:`~paddle_tpu_torch.serving.recovery.DecodeFleet` (or
:class:`~paddle_tpu_torch.serving.disagg.DisaggRouter`) and merges the
per-engine snapshots into fleet-scope rollup families under
``serving.fleet.*``:

- ``serving.fleet.prefix_hit_frac`` — fleet-wide fraction of prompt
  tokens served from a prefix cache (Σ prefix_hit_tokens / Σ
  prompt_tokens);
- ``serving.fleet.host_tier_hit_rate`` / ``host_tier_promote_rate`` —
  hierarchical-KV effectiveness per request and promoted pages per hit;
- ``serving.fleet.breaker_open`` / ``load`` / ``shard_skew`` — per
  engine (``engine=`` label), the health/placement inputs
  (``shard_skew`` per ``group=``, where a group-backed engine publishes
  ``serving.group.shard_skew``);
- ``serving.fleet.engines`` / ``engines_healthy`` / ``handoffs_total``
  / ``rescued_total`` — fleet counts.

:func:`install` registers a view in a module registry so the metrics
exporter can serve ``/fleet`` without holding an object reference, and
:func:`trace_doc` reconstructs one request's cross-engine hop timeline —
spans from every engine under one trace id, validated with
``validate_trace(multi_engine=True)``, correlated runlog events — behind
``/trace/<trace_id>``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import runlog

__all__ = [
    "FleetView",
    "install",
    "uninstall",
    "installed_views",
    "trace_doc",
]

_lock = locks.Lock("observability.fleet")
_views: List["FleetView"] = []


def install(view: "FleetView") -> None:
    """Register a view for exporter discovery (idempotent)."""
    with _lock:
        if view not in _views:
            _views.append(view)


def uninstall(view: "FleetView") -> None:
    with _lock:
        if view in _views:
            _views.remove(view)


def installed_views() -> List["FleetView"]:
    with _lock:
        return list(_views)


class FleetView:
    """Merged telemetry over one fleet's engines.

    ``fleet`` is anything with an ``engines`` list of ``DecodeEngine``\\ s
    and a ``snapshot()`` (``DecodeFleet`` and ``DisaggRouter`` both
    qualify); ``autoscaler`` optionally adds conversion-action counts.
    :meth:`rollup` is pure read — it walks live objects and the metric
    registry, computes the merged numbers, publishes them as
    ``serving.fleet.*`` gauges, and returns them; nothing here touches
    an engine loop thread."""

    def __init__(self, fleet: Any, name: str = "fleet",
                 autoscaler: Any = None):
        enforce(hasattr(fleet, "engines"),
                "FleetView needs a fleet with an .engines list")
        self.fleet = fleet
        self.name = name
        self.autoscaler = autoscaler

    def engines(self) -> List[Any]:
        return list(self.fleet.engines)

    # -- rollup math --------------------------------------------------------

    def rollup(self) -> Dict[str, Any]:
        """Merge per-engine snapshots into the fleet rollup and publish
        the ``serving.fleet.*`` gauge families. Returns the rollup dict
        (the same numbers ``/fleet`` serves)."""
        reg = obs_metrics.default_registry()
        fleet_labels = {"fleet": self.name}
        engines = self.engines()
        totals: Dict[str, float] = {}
        n_healthy = 0
        for eng in engines:
            label = eng.metrics.engine_label
            snap = eng.metrics.snapshot()
            for k, v in snap.items():
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0.0) + float(v)
            breaker = eng.breaker.snapshot()
            is_open = breaker["state"] != "closed"
            if not is_open and not eng.closed:
                n_healthy += 1
            elabels = {"fleet": self.name, "engine": label}
            prof.set_gauge("serving.fleet.breaker_open",
                           1.0 if is_open else 0.0, labels=elabels)
            prof.set_gauge("serving.fleet.load", eng.load(),
                           labels=elabels)
            skew = reg.get("serving.group.shard_skew",
                           labels={"engine": label}, default=None)
            if skew is not None:
                group = getattr(eng, "group", None)
                glabels = {"fleet": self.name,
                           "group": getattr(group, "name", label)}
                prof.set_gauge("serving.fleet.shard_skew", skew,
                               labels=glabels)
        prompt_tokens = totals.get("prompt_tokens_total", 0.0)
        hit_tokens = totals.get("prefix_hit_tokens_total", 0.0)
        requests = totals.get("requests_total", 0.0)
        host_hits = totals.get("host_tier_hits_total", 0.0)
        promoted = totals.get("host_promoted_pages_total", 0.0)
        fleet_snap = self.fleet.snapshot()
        roll: Dict[str, Any] = {
            "engines": len(engines),
            "engines_healthy": n_healthy,
            "prefix_hit_frac": (hit_tokens / prompt_tokens
                                if prompt_tokens else 0.0),
            "host_tier_hit_rate": (host_hits / requests
                                   if requests else 0.0),
            "host_tier_promote_rate": (promoted / host_hits
                                       if host_hits else 0.0),
            "handoffs_total": totals.get("handoffs_in_total", 0.0),
            "rescued_total": float(
                fleet_snap.get("rescued_total", 0)),
            "rescue_failed_total": float(
                fleet_snap.get("rescue_failed_total", 0)),
            "migrated_total": totals.get("migrated_total", 0.0),
            "step_faults_total": totals.get("step_faults_total", 0.0),
        }
        for key in ("prefix_hit_frac", "host_tier_hit_rate",
                    "host_tier_promote_rate"):
            prof.set_gauge(f"serving.fleet.{key}", roll[key],
                           labels=fleet_labels)
        prof.set_gauge("serving.fleet.engines", float(roll["engines"]),
                       labels=fleet_labels)
        prof.set_gauge("serving.fleet.engines_healthy",
                       float(roll["engines_healthy"]), labels=fleet_labels)
        prof.set_gauge("serving.fleet.handoffs_total",
                       roll["handoffs_total"], labels=fleet_labels)
        prof.set_gauge("serving.fleet.rescued_total",
                       roll["rescued_total"], labels=fleet_labels)
        if self.autoscaler is not None:
            for action, n in getattr(self.autoscaler, "actions_total",
                                     {}).items():
                prof.set_gauge("serving.fleet.autoscaler_actions",
                               float(n), labels={"fleet": self.name,
                                                 "action": action})
            roll["autoscaler_actions"] = dict(
                getattr(self.autoscaler, "actions_total", {}))
        return roll

    def doc(self) -> Dict[str, Any]:
        """The ``/fleet`` document: the rollup plus per-engine detail
        (breaker/role/load from the fleet snapshot, the full metrics
        snapshot per engine)."""
        roll = self.rollup()
        fleet_snap = self.fleet.snapshot()
        per_engine = {e.metrics.engine_label: e.metrics.snapshot()
                      for e in self.engines()}
        return {
            "fleet": self.name,
            "rollup": roll,
            "engines": fleet_snap.get("engines", []),
            "metrics": per_engine,
        }


def _span_dict(s: Any) -> Dict[str, Any]:
    return {
        "name": s.name,
        "trace_id": s.context.trace_id,
        "span_id": s.context.span_id,
        "parent_id": s.context.parent_id,
        "t0_us": s.t0_us,
        "t1_us": s.t1_us,
        "engine": s.attrs.get("engine"),
        "attrs": dict(s.attrs),
    }


def trace_doc(trace_id: str) -> Dict[str, Any]:
    """Reconstruct one request's cross-engine timeline: every stored span
    of the trace (start-ordered), the engine hop sequence (order of first
    appearance), structural problems from
    ``validate_trace(multi_engine=True)`` (``[]`` = sound, no orphans),
    and the runlog events stamped with this trace id by the context
    provider. Served at ``/trace/<trace_id>``."""
    from paddle_tpu_torch import tracing

    spans = tracing.spans_for_trace(trace_id)
    problems = (tracing.validate_trace(spans, multi_engine=True)
                if spans else ["trace has no spans"])
    hops: List[str] = []
    for s in spans:
        eng = s.attrs.get("engine")
        if eng is not None and eng not in hops:
            hops.append(eng)
    events: List[Dict[str, Any]] = []
    log = runlog.get_runlog()
    if log is not None:
        try:
            events = [e for e in runlog.read_runlog(log.path)
                      if e.get("trace_id") == trace_id]
        except (OSError, ValueError):
            events = []  # torn tail mid-write: spans still stand alone
    return {
        "trace_id": trace_id,
        "spans": [_span_dict(s) for s in spans],
        "engines": hops,
        "problems": problems,
        "events": events,
    }
