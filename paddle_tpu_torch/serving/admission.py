"""Multi-tenant admission control: shed doomed or over-quota work at
``submit()``, before it consumes queue capacity or device time.

A copy of ``paddle_tpu.serving.admission`` (jax-free) for the PyTorch port,
with the static engine's retry :class:`TokenBucket` and its per-replica
histogram merge (:func:`merge_histogram_snapshots`).

The reference's serving path (gRPC ``listen_and_serv`` + Fluid inference)
admitted everything and let overload manifest as unbounded send queues and
client-side timeouts. Under real multi-tenant overload the right failure
mode is an *early, typed, attributable* rejection — the caller learns
immediately (and cheaply) that its request will not be served, with a
machine-readable reason it can act on (back off, drop priority, try a
different cell). :class:`AdmissionController` rejects at submit when:

- **quota** — the tenant's queue or byte quota is exhausted
  (``queue_quota`` / ``byte_quota``, enforced atomically by the
  scheduler's :meth:`~paddle_tpu_torch.serving.scheduler.WeightedFairScheduler.
  try_put`);
- **deadline_unmeetable** — the request's deadline cannot be met given the
  tenant's predicted queue wait plus the engine's p90 execute latency,
  both read from the histogram families the engine already collects (GDP's
  idea applied operationally: predict from observed costs instead of
  hard-coding); a request that would expire in the queue is pure waste;
- **brownout** — :meth:`AdmissionController.enter_brownout` (in the JAX
  package, the watch layer's SLO burn-rate alerting) says the engine is
  violating its objectives: batch-class admission sheds first
  (severity ``warning`` → level 1), interactive last (``critical`` →
  level 2). Brownout exits via probing: once the minimum dwell time has
  passed and the SLO probe reports no breach, admission reopens.

Every decision is observable: ``serving.tenant.*`` counters/gauges, runlog
``admission_shed`` / ``brownout_enter`` / ``brownout_exit`` events carrying
the request's trace id, and :meth:`AdmissionController.snapshot` for every
:func:`install`-ed controller (what the JAX package's exporter serves at
``/tenants``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.serving import scheduler as sched_mod

__all__ = [
    "AdmissionRejected",
    "TenantConfig",
    "TokenBucket",
    "AdmissionController",
    "merge_histogram_snapshots",
    "install",
    "uninstall",
    "installed_controllers",
]

# brownout severities → levels: warning sheds batch, critical sheds all
_BROWNOUT_LEVELS = {"warning": 1, "critical": 2}


class AdmissionRejected(RuntimeError):
    """Typed early rejection at ``submit()``. ``reason`` is machine-usable:
    ``queue_quota`` | ``byte_quota`` | ``deadline_unmeetable`` |
    ``brownout`` | ``unknown_tenant``."""

    def __init__(self, reason: str, tenant: str, cls: str, detail: str = ""):
        self.reason = reason
        self.tenant = tenant
        self.cls = cls
        msg = f"admission rejected [{reason}] tenant={tenant} class={cls}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclasses.dataclass
class TenantConfig:
    """One tenant's scheduling weight, quotas, and default priority class.
    ``None`` fields resolve from the ``PADDLE_TPU_TENANT_*`` flags
    (:meth:`resolved`), so fleet-wide defaults live in the environment and
    per-tenant overrides in code."""

    name: str
    weight: float = 1.0
    # max requests queued for this tenant across both classes
    queue_capacity: Optional[int] = None
    # max queued payload bytes (0 = unlimited)
    byte_quota: Optional[int] = None
    # class used when submit() passes cls=None: "interactive" | "batch"
    default_class: Optional[str] = None

    def resolved(self) -> "TenantConfig":
        f = cfg.flags()
        out = TenantConfig(
            name=self.name,
            weight=self.weight,
            queue_capacity=(self.queue_capacity
                            if self.queue_capacity is not None
                            else f.tenant_queue_capacity),
            byte_quota=(self.byte_quota if self.byte_quota is not None
                        else f.tenant_byte_quota),
            default_class=(self.default_class
                           if self.default_class is not None
                           else f.tenant_default_class),
        )
        enforce(bool(out.name), "TenantConfig needs a name")
        enforce(out.weight > 0,
                f"tenant {out.name!r}: weight must be > 0, got {out.weight}")
        enforce(out.queue_capacity >= 1,
                f"tenant {out.name!r}: queue_capacity must be >= 1")
        enforce(out.byte_quota >= 0,
                f"tenant {out.name!r}: byte_quota must be >= 0")
        enforce(out.default_class in sched_mod.CLASSES,
                f"tenant {out.name!r}: default_class must be one of "
                f"{sched_mod.CLASSES}, got {out.default_class!r}")
        return out


class TokenBucket:
    """Classic token bucket (thread-safe): ``try_take`` never blocks. Used
    as the per-engine retry budget — retries spend tokens that refill at
    ``rate_per_s``, so a retry storm decays to the budget rate instead of
    amplifying overload."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        enforce(rate_per_s >= 0,
                f"rate_per_s must be >= 0, got {rate_per_s}")
        enforce(burst > 0, f"burst must be > 0, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = locks.Lock("serving.token_bucket")

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self._tokens + (now - self._last) * self.rate)


def merge_histogram_snapshots(snaps: Sequence[Optional[dict]]) -> Optional[dict]:
    """Elementwise-merge {edges, cumulative, sum, count} snapshots sharing
    one bucket layout (e.g. the per-replica children of
    ``serving.replica_exec_seconds``) into one distribution the quantile
    estimator can read. None/empty snapshots are skipped."""
    merged: Optional[dict] = None
    for snap in snaps:
        if snap is None or snap["count"] <= 0:
            continue
        if merged is None:
            merged = {
                "edges": list(snap["edges"]),
                "cumulative": list(snap["cumulative"]),
                "sum": float(snap["sum"]),
                "count": int(snap["count"]),
            }
            continue
        enforce(merged["edges"] == list(snap["edges"]),
                "cannot merge histograms with different bucket layouts")
        merged["cumulative"] = [
            a + b for a, b in zip(merged["cumulative"], snap["cumulative"])
        ]
        merged["sum"] += float(snap["sum"])
        merged["count"] += int(snap["count"])
    return merged


class AdmissionController:
    """Admission policy over one engine's scheduler (see module docstring).

    ``exec_snapshot`` returns the engine's merged execute-latency histogram
    (``merge_histogram_snapshots`` over per-replica children) — the input
    to deadline-feasibility prediction. ``healthy_replicas`` and
    ``slo_probe`` are callables so the controller holds no engine
    reference; ``slo_probe()`` returns True while any serving SLO is still
    breached (brownout must not exit yet)."""

    def __init__(
        self,
        scheduler: sched_mod.WeightedFairScheduler,
        metrics,
        tenants: Dict[str, TenantConfig],
        *,
        exec_snapshot: Optional[Callable[[], Optional[dict]]] = None,
        healthy_replicas: Callable[[], int] = lambda: 1,
        slo_probe: Optional[Callable[[], bool]] = None,
        request_cost: Optional[Callable[[Any], Optional[float]]] = None,
        brownout_min_s: float = 1.0,
        deadline_quantile: float = 0.9,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.scheduler = scheduler
        self.metrics = metrics
        self.tenants = dict(tenants)
        self._total_weight = sum(t.weight for t in tenants.values())
        self._exec_snapshot = exec_snapshot
        self._healthy_replicas = healthy_replicas
        self._slo_probe = slo_probe
        self._request_cost = request_cost
        self.brownout_min_s = float(brownout_min_s)
        self.deadline_quantile = float(deadline_quantile)
        self._clock = clock
        self._lock = locks.Lock("serving.admission")
        self._brownout_level = 0
        self._brownout_since: Optional[float] = None
        self._brownout_reason = ""

    # -- brownout ----------------------------------------------------------

    @property
    def brownout_level(self) -> int:
        with self._lock:
            return self._brownout_level

    def enter_brownout(self, severity: str, reason: str = "") -> None:
        """Raise the brownout level (never lowers it — a critical alert
        during a warning-level brownout escalates; the probe path is the
        only way down). Level 1 sheds batch admission, level 2 sheds all."""
        level = _BROWNOUT_LEVELS.get(severity, 1)
        with self._lock:
            if level <= self._brownout_level:
                self._brownout_since = self._clock()  # extend the dwell
                return
            self._brownout_level = level
            self._brownout_since = self._clock()
            self._brownout_reason = reason
        self.metrics.set_brownout_level(level)
        runlog.emit("brownout_enter", level=level, severity=severity,
                    reason=reason, engine=self.metrics.engine_label)

    def exit_brownout(self) -> None:
        with self._lock:
            if self._brownout_level == 0:
                return
            level = self._brownout_level
            self._brownout_level = 0
            self._brownout_since = None
            self._brownout_reason = ""
        self.metrics.set_brownout_level(0)
        runlog.emit("brownout_exit", level=level,
                    engine=self.metrics.engine_label)

    def _brownout_check(self) -> int:
        """Current brownout level, probing for exit when the dwell time has
        passed and the SLO probe no longer reports a breach."""
        with self._lock:
            level = self._brownout_level
            since = self._brownout_since
        if level == 0:
            return 0
        if since is not None and self._clock() - since >= self.brownout_min_s:
            breached = True
            if self._slo_probe is not None:
                try:
                    breached = bool(self._slo_probe())
                except Exception:
                    breached = True  # a broken probe must fail shed-ward
            if not breached:
                self.exit_brownout()
                return 0
            with self._lock:
                self._brownout_since = self._clock()  # re-arm the dwell
        return level

    # -- deadline feasibility ----------------------------------------------

    def predicted_latency(self, tenant: str) -> Optional[float]:
        """Predicted queue-wait + p-``deadline_quantile`` execute latency
        for one more request from ``tenant``, from observed costs. None =
        no execute history yet (cold start admits everything: shedding on
        zero data would reject the traffic that builds the model)."""
        if self._exec_snapshot is None:
            return None
        snap = self._exec_snapshot()
        if snap is None or snap["count"] <= 0 or snap["sum"] <= 0:
            return None
        mean_exec = snap["sum"] / snap["count"]
        p_exec = obs_metrics.histogram_quantile(
            snap["edges"], snap["cumulative"], snap["count"],
            self.deadline_quantile)
        replicas = max(1, self._healthy_replicas())
        # batches/s the engine can drain; approximating one queued request
        # per batch is pessimistic exactly when overloaded (requests stop
        # coalescing once queues build), which is the regime that matters
        batch_rate = replicas / max(mean_exec, 1e-9)
        t = self.tenants[tenant]
        share = t.weight / max(self._total_weight, 1e-9)
        queued = self.scheduler.depths()[tenant]
        depth = sum(queued[c] for c in sched_mod.CLASSES)
        wait = depth / max(batch_rate * share, 1e-9)
        return wait + p_exec

    def _predict_for(self, req, tenant: str) -> Optional[float]:
        """Per-request latency prediction. The per-request cost model (when
        wired) wins over the whole-request histogram: for autoregressive
        decode, whole-request latency distributions misprice long
        generations — the decode engine supplies per-token cost ×
        ``max_new_tokens`` instead (see serving.decode.DecodeCostModel).
        A None or failing cost model falls back to the histogram path, and
        both return None when cold (admit everything; shedding on zero data
        would reject the traffic that builds the model)."""
        if self._request_cost is not None:
            try:
                predicted = self._request_cost(req)
            except Exception:
                predicted = None  # a broken cost model must not shed
            if predicted is not None:
                return float(predicted)
        return self.predicted_latency(tenant)

    # -- the decision ------------------------------------------------------

    def admit(self, req) -> None:
        """Admit ``req`` into the scheduler or raise
        :class:`AdmissionRejected`. Order: tenant identity → brownout →
        deadline feasibility → quota (the cheap/global checks first, the
        per-tenant stateful one last so a shed burns no queue state)."""
        tenant, rcls = req.tenant, req.cls
        if tenant not in self.tenants:
            self._shed(req, "unknown_tenant",
                       f"not one of {sorted(self.tenants)}")
        level = self._brownout_check()
        if level >= 2 or (level == 1 and rcls == sched_mod.BATCH):
            self._shed(req, "brownout",
                       f"level={level} reason={self._brownout_reason}")
        if req.deadline is not None:
            predicted = self._predict_for(req, tenant)
            remaining = req.deadline - self._clock()
            if predicted is not None and predicted > remaining:
                self._shed(
                    req, "deadline_unmeetable",
                    f"predicted {predicted:.4f}s > remaining {remaining:.4f}s")
        reason = self.scheduler.try_put(req)
        if reason is not None:
            self._shed(req, reason)
        self.metrics.record_admit(tenant, rcls)

    def _shed(self, req, reason: str, detail: str = "") -> None:
        self.metrics.record_shed(req.tenant, req.cls, reason)
        fields = dict(reason=reason, tenant=req.tenant, cls=req.cls,
                      engine=self.metrics.engine_label)
        if getattr(req, "trace", None) is not None:
            fields["trace_id"] = req.trace.trace_id
        runlog.emit("admission_shed", **fields)
        raise AdmissionRejected(reason, req.tenant, req.cls, detail)

    # -- readout (/tenants) ------------------------------------------------

    def snapshot(self) -> dict:
        depths = self.scheduler.depths()
        with self._lock:
            brownout = {
                "level": self._brownout_level,
                "since": self._brownout_since,
                "reason": self._brownout_reason,
            }
        return {
            "engine": self.metrics.engine_label,
            "brownout": brownout,
            "batch_min_share": self.scheduler.batch_min_share,
            "tenants": {
                name: {
                    "weight": t.weight,
                    "queue_capacity": t.queue_capacity,
                    "byte_quota": t.byte_quota,
                    "default_class": t.default_class,
                    "queued": depths.get(name, {}),
                    "admitted_total": self.metrics.tenant_admitted(name),
                    "shed_total": self.metrics.tenant_shed(name),
                }
                for name, t in self.tenants.items()
            },
        }


# -- process-wide install (the controllers a /tenants endpoint would serve) --

_installed_lock = locks.Lock("serving.admission_install")
_installed: List[AdmissionController] = []


def install(controller: AdmissionController) -> AdmissionController:
    """Register a controller process-wide (:func:`installed_controllers`)."""
    with _installed_lock:
        if controller not in _installed:
            _installed.append(controller)
    return controller


def uninstall(controller: AdmissionController) -> None:
    with _installed_lock:
        if controller in _installed:
            _installed.remove(controller)


def installed_controllers() -> List[AdmissionController]:
    with _installed_lock:
        return list(_installed)
