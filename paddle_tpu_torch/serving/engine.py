"""ServingEngine: dynamically-batched inference serving, port of
``paddle_tpu.serving.engine``.

What limits a device under mixed request load is occupancy (a card running
batch-1 requests is idle silicon) and the first call at each shape (cuBLAS
and cuDNN algorithm choice, the caching allocator, the kernels' ``nvcc``
build on the first call of the process). The engine batches requests and
runs every padded shape once at startup.

Request path::

    submit(feed) ──▶ admission control (typed shedding, multi-tenant)
        ──▶ per-tenant queues / weighted-fair scheduler ──▶ MicroBatcher
        ──▶ shape-bucket groups, padded to (signature, batch bucket)
        ──▶ round-robin replica Channel ──▶ replica worker thread
        ──▶ Executor.prepare-cached forward on that replica's device
        ──▶ one copy of the batch's outputs to the host, then per-request
            row slices complete each PendingResult

Key properties, as in the JAX package:

- **Warm-up**: every (signature, batch bucket) runs once at startup on
  every replica (the JAX package compiles each ahead of time), so steady
  traffic never pays a first call. :meth:`ServingEngine.aot_cache_sizes`
  counts, per replica, the distinct input shapes its forward has run;
  after warm-up it does not change under traffic.
- **Dynamic micro-batching**: max batch size + max queue delay, padding to
  shape buckets derived from ``FeedSpec`` (see ``serving.buckets``).
- **Replica round-robin**: on CUDA one replica per card
  (``torch.cuda.device_count()``, clamped by ``num_replicas`` as the JAX
  package clamps its local devices), each with its own copy of the
  variables on ``cuda:i``; batches rotate across them, each replica with
  its own circuit breaker. On the CPU, which the caller must ask for
  (``place="cpu"``), ``num_replicas=n`` gives n replicas that share the
  CPU (the JAX tests' 8-device CPU mesh plays that part there).
- **Deadlines**: a request carries an absolute deadline; if it expires in
  the queue it gets a :class:`DeadlineExceeded` response without spending
  device time.
- **Backpressure / admission**: the request queue is bounded; without
  tenants ``submit`` blocks (or times out) when the engine is saturated.
  With tenants configured, admission control sheds early and typed
  instead — per-tenant quotas, deadline-feasibility prediction from
  observed latencies, and SLO-driven brownout (``serving.admission`` /
  ``serving.scheduler``; the watch layer drives brownout and, with
  ``anomaly_eject``, replica ejection).
- **Graceful drain**: ``close()`` stops intake, lets the batcher flush
  everything already accepted, waits for the replica workers, and only
  then returns — no accepted request is dropped.

- **Model lint**: before warm-up the model is traced on the ``meta``
  device (``analysis.lint_model``: no kernel, no device memory) over the
  smallest warm-up signature and each finding is logged once. Best
  effort, as in the JAX package: a failure of the lint is logged, never
  fatal.

Not ported yet: the persistent warm-up manifest and :meth:`ServingEngine.
prewarm` (``tune/``, ``ROADMAP.md`` §A item 7: ``ServingConfig(prewarm=
True)`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch import observability, tracing
from paddle_tpu_torch.concurrency import Channel, ChannelClosedError, go
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import retry as retry_mod
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.framework import Model, Variables, build
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.reader.feeder import FeedSpec
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.circuit import CircuitBreaker
from paddle_tpu_torch.serving import admission as admission_mod
from paddle_tpu_torch.serving import scheduler as sched_mod
from paddle_tpu_torch.serving.admission import AdmissionRejected, TenantConfig
from paddle_tpu_torch.serving.batcher import Group, MicroBatcher
from paddle_tpu_torch.serving.buckets import ShapeBuckets
from paddle_tpu_torch.serving.metrics import ServingMetrics

__all__ = [
    "ServingEngine",
    "ServingConfig",
    "PendingResult",
    "DeadlineExceeded",
    "EngineClosedError",
    "ReplicaDied",
    "AdmissionRejected",
    "TenantConfig",
]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it reached a device."""


class EngineClosedError(RuntimeError):
    """submit() after close() — the engine no longer accepts requests."""


class ReplicaDied(RuntimeError):
    """The replica worker thread exited while this request was queued on
    its channel (and no healthy replica could take the batch)."""


def _not_ported(what: str, item: int, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine: {what} needs {module}, which is not ported to paddle_tpu_torch "
        f"yet (ROADMAP.md §A item {item})")


@dataclasses.dataclass
class ServingConfig:
    """Batching, replica and intake policy knobs of the serving engines
    (:class:`ServingEngine`; :class:`~paddle_tpu_torch.serving.decode.
    DecodeEngine` reads the intake, tenant and cache-dtype ones)."""

    max_batch_size: int = 8
    # latency budget a request may wait for co-batching company
    max_queue_delay_s: float = 0.005
    # bounded request queue: submit blocks past this depth (backpressure)
    queue_capacity: int = 64
    # padded batch sizes warmed at startup; default powers of 2 up to max_batch
    batch_buckets: Optional[Sequence[int]] = None
    # padded lengths for ragged FeedSpec dims (required if any are ragged)
    length_buckets: Optional[Sequence[int]] = None
    # metric label distinguishing this engine's families in the registry;
    # None = auto ("serving0", "decode1", ... one sequence per process)
    engine_label: Optional[str] = None
    # device replicas; None = every card (one on the CPU)
    num_replicas: Optional[int] = None
    # run every (signature, batch bucket) once on every replica at startup
    warmup: bool = True
    # replay the persisted warm-up manifest (tune/, not ported: True raises)
    prewarm: Optional[bool] = None
    # trace the model through analysis.lint_model on the meta device before
    # warm-up and log its findings (never fatal)
    lint_model: bool = True
    # default per-request deadline; None = no deadline
    default_deadline_s: Optional[float] = None
    # -- replica health (resilience.circuit.CircuitBreaker per replica) ----
    # consecutive batch failures that eject a replica from rotation
    replica_failure_threshold: int = 3
    # cooldown before an ejected replica gets a half-open probe batch;
    # successive re-trips back off exponentially up to the max
    replica_cooldown_s: float = 1.0
    replica_max_cooldown_s: float = 30.0
    # flag a replica whose execute durations exceed the cross-replica
    # baseline by this ratio (None = the straggler_ratio flag; see
    # paddle_tpu_torch.tracing.straggler)
    straggler_ratio: Optional[float] = None
    # -- watch layer (paddle_tpu_torch.watch: anomaly detection + SLOs) ----
    # attach a MetricWatcher/SloEngine to this engine's metric streams;
    # None = no watching (watch.WatchConfig(enabled=True) for defaults)
    watch: Optional[Any] = None
    # let a per-replica latency-anomaly alert trip that replica's circuit
    # breaker (same ejection path as consecutive failures) — requires a
    # watch config with the per-replica exec rule (on by default)
    anomaly_eject: bool = False
    # -- multi-tenant admission (serving.admission / serving.scheduler) ----
    # tenant set (admission.TenantConfig) for weighted-fair scheduling;
    # None = one implicit "default" tenant with legacy FIFO backpressure
    tenants: Optional[Sequence[TenantConfig]] = None
    # early typed shedding at submit() (AdmissionRejected); None = enabled
    # exactly when tenants are configured
    admission: Optional[bool] = None
    # guaranteed batch-class drain share under interactive pressure; None =
    # the tenant_batch_min_share flag
    batch_min_share: Optional[float] = None
    # minimum dwell in brownout before the SLO probe may exit it
    brownout_min_s: float = 1.0
    # per-engine retry budget for submit(retries=...): a token bucket so
    # client retry storms cannot amplify overload
    retry_budget_per_s: float = 8.0
    retry_budget_burst: float = 16.0
    # -- autoregressive decode (serving.decode.DecodeEngine) ---------------
    # KV-cache dtype for decode engines built over this config (e.g.
    # torch.bfloat16 halves the cache's memory traffic); None = f32. The
    # static-batch path ignores it.
    cache_dtype: Optional[Any] = None


class PendingResult:
    """Future-like handle for one submitted request. ``trace`` carries the
    request's root :class:`~paddle_tpu_torch.tracing.SpanContext` (None
    with tracing off) so callers can reconstruct the request's span tree
    (``tracing.spans_for_trace``) or propagate it onward
    (``trace.to_traceparent()``)."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.trace = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


class _Request:
    __slots__ = ("arrays", "n", "sig", "deadline", "t_submit", "pending",
                 "tenant", "cls", "bytes",
                 "trace", "t_enqueue_pc", "t_grouped_pc", "t_dispatch_pc")

    def __init__(self, arrays, n, sig, deadline, t_submit,
                 tenant="default", cls="interactive"):
        self.arrays = arrays
        self.n = n
        self.sig = sig
        self.deadline = deadline
        self.t_submit = t_submit
        self.tenant = tenant
        self.cls = cls
        self.bytes = sum(int(a.nbytes) for a in arrays)
        self.pending = PendingResult()
        # tracing: root context + perf_counter marks (t_submit stays on
        # time.monotonic for deadline math; spans share the profiler
        # timebase). t_dispatch_pc is stamped by the router BEFORE the
        # replica-channel send; the worker turns it into the
        # serving.dispatch span.
        self.trace = None
        self.t_enqueue_pc: Optional[float] = None
        self.t_grouped_pc: Optional[float] = None
        self.t_dispatch_pc: Optional[float] = None


class _Replica:
    __slots__ = (
        "index", "exe", "variables", "compiled", "channel", "thread",
        "breaker", "dead",
    )

    def __init__(self, index: int, exe: Executor, variables, compiled, channel, breaker):
        self.index = index
        self.exe = exe
        self.variables = variables
        self.compiled = compiled
        self.channel = channel
        self.thread = None
        self.breaker = breaker  # health gate: CLOSED/OPEN/HALF_OPEN
        self.dead = False       # worker thread exited abnormally


def _replica_devices(place, num_replicas: Optional[int]) -> List[torch.device]:
    """One device per replica: each card for CUDA (or the one card named),
    clamped by ``num_replicas``; ``num_replicas`` replicas sharing the CPU."""
    dev = cfg.resolve_device(place)
    if dev.type == "cpu":
        return [dev] * max(1, num_replicas or 1)
    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if dev.index is None else [dev])
    return cards[:max(1, num_replicas or len(cards))]


def _variables_on(variables: Variables, dev: torch.device) -> Variables:
    return Variables(
        params={k: v.to(dev) for k, v in variables.params.items()},
        state={k: v.to(dev) for k, v in variables.state.items()},
    )


def _to_host(leaf):
    return leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf


class ServingEngine:
    """Concurrent inference over a trained :class:`Model`.

    ::

        engine = ServingEngine(infer_net, variables, feed_specs)
        out = engine.infer({"x": batch})          # sync
        fut = engine.submit({"x": batch})          # async
        ...
        engine.close()                             # graceful drain

    ``place`` is the device (``"cuda"``, the default, or ``"cpu"``), as
    for :class:`~paddle_tpu_torch.executor.Executor`. Results come back as
    CPU tensors (each request's rows of the batch's outputs).
    """

    def __init__(
        self,
        model: Union[Model, Any],
        variables: Union[Variables, str],
        feed_specs: Sequence[FeedSpec],
        config: Optional[ServingConfig] = None,
        place=None,
    ):
        self.config = config or ServingConfig()
        if self.config.prewarm:
            raise _not_ported("prewarm=True (the persisted warm-up manifest)", 7, "tune/")
        self.model = model if isinstance(model, Model) else build(model)
        devices = _replica_devices(place if place is not None else "cuda",
                                   self.config.num_replicas)
        if isinstance(variables, str):
            from paddle_tpu_torch import io as io_mod

            variables = io_mod.load_params(variables, device=devices[0])
        self.specs = list(feed_specs)
        enforce(bool(self.specs), "feed_specs must be non-empty")
        self.buckets = ShapeBuckets(
            self.specs,
            self.config.max_batch_size,
            batch_buckets=self.config.batch_buckets,
            length_buckets=self.config.length_buckets,
        )
        self.metrics = ServingMetrics(engine_label=self.config.engine_label)
        observability.setup()  # flags-driven exporter/runlog, idempotent
        # cross-replica skew watch over per-batch execute durations
        self._straggler = tracing.StragglerDetector(
            "serving.execute", ratio=self.config.straggler_ratio
        )
        # watch layer: anomaly detectors / SLOs over this engine's metric
        # streams, attached via config (paddle_tpu_torch.watch)
        self._watcher = None
        if self.config.watch is not None:
            from paddle_tpu_torch import watch as watch_mod

            self._watcher = watch_mod.build(self.config.watch)
            if self._watcher is not None and self.config.anomaly_eject:
                self._watcher.hub.register_action(self._on_alert)
        self._closed = False
        self._close_lock = locks.Lock("serving.engine_close")
        self._rr = 0  # round-robin cursor (guarded by _pick_lock)
        # replica picking happens on the batcher thread AND on worker
        # threads redispatching a failed batch
        self._pick_lock = locks.Lock("serving.engine_pick")

        n_rep = len(devices)

        def _fwd(vs, *arrays):
            out, _ = self.model.apply(vs, *arrays, is_train=False)
            return out

        self._fwd = _fwd

        self._replicas: List[_Replica] = []
        for i, dev in enumerate(devices):
            exe = Executor(dev)
            rep_vars = _variables_on(variables, exe.device)
            compiled = exe.prepare(self._fwd, key=("serving", self.model.name, i))
            breaker = CircuitBreaker(
                failure_threshold=self.config.replica_failure_threshold,
                cooldown_s=self.config.replica_cooldown_s,
                max_cooldown_s=self.config.replica_max_cooldown_s,
            )
            self._replicas.append(
                _Replica(i, exe, rep_vars, compiled, Channel(capacity=2), breaker)
            )
        self.metrics.set_healthy_replicas(n_rep)

        # the model lint's findings; None when it did not run (off or failed)
        self.lint_findings: Optional[List] = None
        if self.config.lint_model:
            self._lint_model(variables)
        if self.config.warmup:
            self._warmup()

        # per-tenant queues + weighted-fair drain; with no tenants configured
        # one implicit "default" tenant plus legacy_capacity reproduces the
        # bounded-FIFO contract (submit blocks on a full queue) exactly
        tenant_cfgs = [t.resolved() for t in (self.config.tenants or ())]
        if not tenant_cfgs:
            tenant_cfgs = [TenantConfig(
                "default", queue_capacity=self.config.queue_capacity,
            ).resolved()]
        self._tenants = {t.name: t for t in tenant_cfgs}
        self._default_tenant = (
            "default" if "default" in self._tenants else tenant_cfgs[0].name)
        admission_on = (self.config.admission
                        if self.config.admission is not None
                        else self.config.tenants is not None)
        self._queue = sched_mod.WeightedFairScheduler(
            self._tenants,
            quantum_rows=self.config.max_batch_size,
            batch_min_share=(self.config.batch_min_share
                             if self.config.batch_min_share is not None
                             else cfg.flags().tenant_batch_min_share),
            legacy_capacity=(None if admission_on
                             else self.config.queue_capacity),
            on_expired=self._expire,
        )
        self._retry_budget = admission_mod.TokenBucket(
            self.config.retry_budget_per_s, self.config.retry_budget_burst)
        self._admission: Optional[admission_mod.AdmissionController] = None
        if admission_on:
            self._admission = admission_mod.AdmissionController(
                self._queue, self.metrics, self._tenants,
                exec_snapshot=self._merged_exec_snapshot,
                healthy_replicas=self._count_healthy,
                slo_probe=self._slo_breached,
                brownout_min_s=self.config.brownout_min_s,
            )
            admission_mod.install(self._admission)
            if self._watcher is not None:
                # SLO burn-rate breaches drive brownout shedding
                self._watcher.hub.register_action(self._on_brownout_alert)
        self._batcher = MicroBatcher(
            self._queue,
            max_batch_rows=self.config.max_batch_size,
            max_delay_s=self.config.max_queue_delay_s,
            flush=self._dispatch,
            on_expired=self._expire,
        )
        for rep in self._replicas:
            rep.thread = go(self._worker, rep)
        self._batcher_thread = go(self._batcher.run)

    # -- startup -----------------------------------------------------------

    def _lint_model(self, variables) -> None:
        """Trace the model on the ``meta`` device over the smallest warm-up
        signature (no kernel, no device memory) and log its structural
        findings (stale params, sharding-rank mismatches, f64 leaks) once
        each, before warm-up. Best effort: a failure of the lint is logged
        and never blocks serving."""
        try:
            from paddle_tpu_torch.analysis import lint_model as _lint

            sig = sorted(self.buckets.all_signatures())[0]
            rows = min(self.buckets.batch_buckets)
            diags = _lint(self.model, self._zeros_for(sig, rows), variables=variables,
                          train=False)
            self.lint_findings = list(diags)
            for d in diags:
                ptlog.warn_once(
                    ("serving-model-lint", self.model.name, d.code, d.where),
                    "model lint [%s]: %s", d.code, str(d),
                )
        except Exception as e:  # the lint never blocks serving
            ptlog.warn_once(
                ("serving-model-lint-failed", self.model.name),
                "model lint skipped: %s", e,
            )

    def _zeros_for(self, sig, rows: int):
        return [
            np.zeros((rows,) + shape, dtype=spec.dtype)
            for spec, shape in zip(self.specs, sig)
        ]

    def _run(self, rep: _Replica, slots):
        """One padded batch through ``rep``'s forward, its outputs copied to
        the host once (``jax.device_get`` in the JAX package)."""
        dev = rep.exe.device
        on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with torch.no_grad(), on_card:
            out = rep.compiled(rep.variables, *rep.exe.put(list(slots)))
            return tree_mod.map_leaves(_to_host, out)

    def _warmup(self) -> None:
        """Run every (signature, batch bucket) once on every replica so live
        traffic never pays a first call at a shape (the JAX package's AOT
        compile)."""
        with prof.record_event("serving.warmup"):
            for sig in self.buckets.all_signatures():
                for b in self.buckets.batch_buckets:
                    args = self._zeros_for(sig, b)
                    for rep in self._replicas:
                        self._run(rep, args)
                        self.metrics.record_warmup()

    def prewarm(self) -> int:
        """Replays the persisted warm-up manifest in the JAX package
        (``tune/warmup.py``); not ported yet."""
        raise _not_ported("prewarm() (the persisted warm-up manifest)", 7, "tune/")

    def aot_cache_sizes(self) -> List[int]:
        """Per-replica count of distinct input shapes its forward has run.
        Steady after warm-up ⇒ no request ever met a shape for the first
        time."""
        return [rep.compiled.signature_count() for rep in self._replicas]

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    # -- request intake ----------------------------------------------------

    def _normalize_feed(self, feed) -> Tuple[np.ndarray, ...]:
        """feed → per-slot arrays in FeedSpec order. Dict feeds are looked
        up BY NAME (never by insertion order); sequences must already be in
        spec order."""
        if isinstance(feed, dict):
            missing = [s.name for s in self.specs if s.name not in feed]
            if missing:
                raise EnforceError(f"feed missing slots {missing}")
            arrays = [feed[s.name] for s in self.specs]
        else:
            if not isinstance(feed, (tuple, list)):
                feed = (feed,)  # bare array = the single feed slot
            enforce(
                len(feed) == len(self.specs),
                f"expected {len(self.specs)} feed slots, got {len(feed)}",
            )
            arrays = list(feed)
        return tuple(
            np.asarray(a, dtype=spec.dtype)
            for a, spec in zip(arrays, self.specs)
        )

    def submit(
        self,
        feed,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
        tenant: Optional[str] = None,
        cls: Optional[str] = None,
        retries: int = 0,
        backoff: float = 0.01,
    ) -> PendingResult:
        """Enqueue one request (arrays carry a leading batch dim). Returns a
        :class:`PendingResult`.

        Without admission control the bounded queue applies backpressure:
        submit blocks while full, ``timeout`` bounds that wait
        (TimeoutError = backpressure rejection). With tenants configured,
        submit never blocks — it raises :class:`AdmissionRejected` with a
        typed reason instead. An already-expired ``deadline_s`` (<= 0) is
        rejected here as :class:`DeadlineExceeded`, before it can occupy a
        queue slot.

        ``tenant``/``cls`` attribute the request for scheduling (defaults:
        the "default" tenant — or the first configured one — and that
        tenant's default class). ``retries > 0`` retries rejections
        (AdmissionRejected / backpressure TimeoutError, never
        DeadlineExceeded) with jittered exponential backoff starting at
        ``backoff`` seconds, capped by the per-engine retry-budget token
        bucket so storms cannot amplify overload.
        """
        enforce(retries >= 0, f"retries must be >= 0, got {retries}")
        attempt = 0
        while True:
            try:
                return self._submit_once(feed, deadline_s, timeout,
                                         tenant, cls)
            except (AdmissionRejected, TimeoutError) as e:
                if isinstance(e, DeadlineExceeded) or attempt >= retries:
                    raise
                if not self._retry_budget.try_take():
                    self.metrics.record_retry_budget_exhausted()
                    raise
                self.metrics.record_retry()
                time.sleep(retry_mod.next_backoff(
                    attempt, base_delay=backoff, max_delay=1.0))
                attempt += 1

    def _submit_once(
        self,
        feed,
        deadline_s: Optional[float],
        timeout: Optional[float],
        tenant: Optional[str],
        cls: Optional[str],
    ) -> PendingResult:
        if self._closed:
            raise EngineClosedError("engine is closed")
        arrays = self._normalize_feed(feed)
        rows = {int(a.shape[0]) for a in arrays if a.ndim > 0}
        enforce(len(rows) == 1, f"feed slots disagree on batch dim: {rows}")
        n = rows.pop()
        enforce(
            1 <= n <= self.config.max_batch_size,
            f"request rows {n} outside [1, {self.config.max_batch_size}]",
        )
        sig = self.buckets.signature([a.shape[1:] for a in arrays])
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            # already dead on arrival: reject without burning a queue slot
            self.metrics.record_timeout()
            raise DeadlineExceeded(
                f"deadline {deadline_s}s already expired at submit")
        deadline = None if deadline_s is None else now + deadline_s
        tname = tenant if tenant is not None else self._default_tenant
        tcfg = self._tenants.get(tname)
        rcls = cls if cls is not None else (
            tcfg.default_class if tcfg is not None
            else cfg.flags().tenant_default_class)
        enforce(rcls in sched_mod.CLASSES,
                f"unknown priority class {rcls!r} "
                f"(expected one of {sched_mod.CLASSES})")
        if self._admission is None:
            # admission rejects unknown tenants with a typed reason; the
            # legacy blocking path has no shed channel, so refuse up front
            enforce(tcfg is not None,
                    f"unknown tenant {tname!r} "
                    f"(configured: {sorted(self._tenants)})")
        req = _Request(arrays, n, sig, deadline, now, tenant=tname, cls=rcls)
        if tracing.tracing_enabled():
            req.trace = tracing.SpanContext.new_trace()
            req.pending.trace = req.trace
            req.t_enqueue_pc = time.perf_counter()
        try:
            if self._admission is not None:
                # never blocks: quota/deadline/brownout shedding raises a
                # typed AdmissionRejected instead of parking the caller
                self._admission.admit(req)
            else:
                self._queue.send(req, timeout=timeout)
        except ChannelClosedError:
            raise EngineClosedError("engine is closed") from None
        except AdmissionRejected:
            if req.trace is not None:
                self._finish_trace(req, time.perf_counter(), status="shed")
            raise
        if req.trace is not None:
            # the enqueue span covers any backpressure wait on the bounded
            # channel — visible queue-pressure in the request's own trace
            tracing.record_span(
                "serving.enqueue", req.t_enqueue_pc, time.perf_counter(),
                parent=req.trace, rows=n, tenant=tname, cls=rcls,
            )
        # counted only once accepted: a backpressure rejection (TimeoutError
        # above) never shows up as a request that went missing
        self.metrics.record_submit(n, self._queue.qsize())
        return req.pending

    def infer(self, feed, deadline_s: Optional[float] = None, **kwargs):
        """Synchronous request: submit + wait. Raises
        :class:`DeadlineExceeded` if the deadline expires in the queue.
        Extra kwargs (``tenant``, ``cls``, ``retries``...) pass through to
        :meth:`submit`."""
        return self.submit(feed, deadline_s=deadline_s, **kwargs).result()

    # -- batching / dispatch (batcher thread) ------------------------------

    def _finish_trace(self, req: _Request, t1_pc: float, **attrs) -> None:
        """Record the request's ROOT span (serving.request) — every
        completion path runs through exactly one of the three callers
        (worker success, _expire, _fail_requests), always before the
        PendingResult is released so a caller that checks the trace right
        after result() finds it complete."""
        if req.trace is None:
            return
        tracing.record_span(
            "serving.request", req.t_enqueue_pc, t1_pc, context=req.trace,
            rows=req.n, engine=self.metrics.engine_label,
            tenant=req.tenant, cls=req.cls, **attrs,
        )

    def _expire(self, req: _Request) -> None:
        self.metrics.record_timeout()
        if req.trace is not None:
            now_pc = time.perf_counter()
            tracing.record_span(
                "serving.queue_wait", req.t_enqueue_pc, now_pc,
                parent=req.trace,
            )
            self._finish_trace(req, now_pc, status="deadline_exceeded")
        req.pending._fail(
            DeadlineExceeded(
                f"request expired after {time.monotonic() - req.t_submit:.3f}s in queue"
            )
        )

    def _dispatch(self, group: Group) -> None:
        """Pad one signature group to its batch bucket and round-robin it to
        a replica. Runs on the batcher thread; a busy replica channel blocks
        here, which is the intended backpressure toward the request queue."""
        live = []
        now = time.monotonic()
        for req in group.requests:
            if req.deadline is not None and now > req.deadline:
                self._expire(req)
            else:
                live.append(req)
        if not live:
            return
        t_pad0 = time.perf_counter()
        for req in live:
            if req.trace is not None:
                # queue wait = submit → the moment the batcher grouped it
                tracing.record_span(
                    "serving.queue_wait", req.t_enqueue_pc,
                    req.t_grouped_pc if req.t_grouped_pc is not None else t_pad0,
                    parent=req.trace,
                )
        rows = sum(r.n for r in live)
        bucket_b = self.buckets.batch_bucket(rows)
        slots = []
        for j in range(len(self.specs)):
            per_req = [
                self.buckets.pad_to_signature([r.arrays[j]], group.sig[j : j + 1])[0]
                for r in live
            ]
            col = per_req[0] if len(per_req) == 1 else np.concatenate(per_req, axis=0)
            slots.append(col)
        slots = self.buckets.pad_rows(slots, bucket_b)
        t_pad1 = time.perf_counter()
        for req in live:
            if req.trace is not None:
                tracing.record_span(
                    "serving.pad", t_pad0, t_pad1, parent=req.trace,
                    bucket_rows=bucket_b,
                )
        self.metrics.record_batch(rows, bucket_b, group.sig)
        self.metrics.set_queue_depth(self._queue.qsize())
        self.metrics.set_tenant_depths(self._queue.depths())
        self._send_to_replica(live, slots, bucket_b, attempt=0)

    def _pick_replica(self, exclude: Optional[_Replica] = None) -> Optional[_Replica]:
        """Next replica in round-robin order whose breaker admits a batch.
        When EVERY live breaker is open mid-cooldown, degrade: force a
        half-open probe on the one closest to its retry time — serving at
        reduced health beats failing all traffic. None = no live replicas."""
        with self._pick_lock:
            alive = [r for r in self._replicas if not r.dead and r is not exclude]
            if not alive:
                return None
            n = len(self._replicas)
            for k in range(n):
                rep = self._replicas[(self._rr + k) % n]
                if rep.dead or rep is exclude:
                    continue
                if rep.breaker.allow():
                    self._rr = (self._rr + k + 1) % n
                    return rep
            rep = min(alive, key=lambda r: r.breaker.retry_in())
            rep.breaker.force_allow()
            return rep

    def _send_to_replica(self, live, slots, bucket_b: int, attempt: int) -> None:
        """Route one padded batch to a healthy replica; a replica dying
        between pick and send is retried against the others. With no live
        replica left, the callers fail instead of hanging."""
        t0 = time.perf_counter()
        for req in live:
            # stamped BEFORE the send: the send wakes the worker, which can
            # complete the request before this thread runs again, so the
            # worker itself records serving.dispatch (see _worker_loop) to
            # keep every span committed ahead of the result release
            req.t_dispatch_pc = t0
        exclude = None
        for _ in range(len(self._replicas)):
            rep = self._pick_replica(exclude=exclude)
            if rep is None:
                break
            try:
                rep.channel.send((live, slots, bucket_b, attempt))
                return
            except ChannelClosedError:
                exclude = rep  # died between pick and send
        self._fail_requests(live, ReplicaDied("no healthy replicas available"))

    def _fail_requests(self, live, exc: BaseException) -> None:
        self.metrics.record_error(len(live))
        now_pc = time.perf_counter()
        for req in live:
            self._finish_trace(req, now_pc, status="error",
                               error=type(exc).__name__)
            req.pending._fail(exc)

    # -- execution (replica worker threads) --------------------------------

    def _worker(self, rep: _Replica) -> None:
        """Replica thread wrapper: ANY exit of the loop itself — including
        BaseException (KeyboardInterrupt, MemoryError, a bug in the loop) —
        marks the replica dead and fails everything queued on its channel,
        so no caller ever hangs on a worker that silently died."""
        try:
            self._worker_loop(rep)
        except BaseException as e:
            self._replica_died(rep, e)

    def _worker_loop(self, rep: _Replica) -> None:
        for live, slots, bucket_b, attempt in rep.channel:
            t_exec0 = time.perf_counter()
            for req in live:
                if req.trace is not None and req.t_dispatch_pc is not None:
                    # covers replica pick + the wait on this worker's
                    # channel; recorded here rather than by the router so
                    # it cannot land after the request's result is released
                    tracing.record_span(
                        "serving.dispatch", req.t_dispatch_pc, t_exec0,
                        parent=req.trace, replica=rep.index, attempt=attempt,
                    )
            try:
                # fault point: a seeded "error" here exercises the breaker
                # exactly like a real device failure would
                faults.inject(faults.SERVING_DISPATCH, replica=rep.index)
                with prof.record_event(f"serving.batch.replica{rep.index}"):
                    out = self._run(rep, slots)
            except Exception as e:  # complete, never hang the callers
                self._batch_failed(rep, live, slots, bucket_b, attempt, e)
                continue
            except BaseException as e:
                # the worker is about to die (KeyboardInterrupt, MemoryError,
                # SystemExit): the in-flight batch must fail, not hang
                self._fail_requests(
                    live, ReplicaDied(f"replica {rep.index} worker died: {e!r}")
                )
                raise
            if rep.breaker.record_success():
                self.metrics.record_replica_recovery()
                runlog.emit("breaker_close", replica=rep.index,
                            engine=self.metrics.engine_label)
                ptlog.vlog(
                    0, "serving replica %d recovered (half-open probe ok)",
                    rep.index,
                )
                self.metrics.set_healthy_replicas(self._count_healthy())
            t_exec1 = time.perf_counter()
            for req in live:
                if req.trace is not None:
                    tracing.record_span(
                        "serving.execute", t_exec0, t_exec1, parent=req.trace,
                        replica=rep.index, attempt=attempt,
                        bucket_rows=bucket_b,
                    )
            self._straggler.record(f"replica{rep.index}", t_exec1 - t_exec0)
            self.metrics.record_exec(rep.index, t_exec1 - t_exec0)
            offset = 0
            now = time.monotonic()
            for req in live:
                sliced = self._slice_out(out, bucket_b, offset, req.n)
                t_reply = time.perf_counter()
                if req.trace is not None:
                    tracing.record_span(
                        "serving.reply", t_exec1, t_reply, parent=req.trace,
                    )
                # root span lands BEFORE the result is released: a caller
                # inspecting the trace right after result() sees it complete
                self._finish_trace(req, t_reply, status="ok",
                                   replica=rep.index)
                req.pending._complete(sliced)
                self.metrics.record_response(now - req.t_submit)
                self.metrics.record_tenant_response(
                    req.tenant, req.cls, now - req.t_submit)
                offset += req.n

    def _batch_failed(
        self, rep: _Replica, live, slots, bucket_b: int, attempt: int,
        exc: Exception,
    ) -> None:
        """One batch failed on ``rep``: charge its breaker and give the
        batch ONE redispatch to a different healthy replica (a sick device
        must not fail callers a healthy one could serve) before failing the
        callers for real."""
        if rep.breaker.record_failure():
            self.metrics.record_replica_ejection()
            runlog.emit("breaker_open", replica=rep.index,
                        engine=self.metrics.engine_label, error=repr(exc))
            ptlog.error(
                "serving replica %d ejected after %d consecutive failures "
                "(retry in %.2fs): %s",
                rep.index, rep.breaker.consecutive_failures,
                rep.breaker.retry_in(), exc,
            )
            self.metrics.set_healthy_replicas(self._count_healthy())
        if attempt == 0:
            target = self._pick_replica(exclude=rep)
            if target is not None:
                t0 = time.perf_counter()
                for req in live:
                    req.t_dispatch_pc = t0  # target worker records the span
                try:
                    target.channel.send((live, slots, bucket_b, 1), timeout=5.0)
                    t1 = time.perf_counter()
                    for req in live:
                        if req.trace is not None:
                            tracing.record_span(
                                "serving.redispatch", t0, t1,
                                parent=req.trace, from_replica=rep.index,
                                to_replica=target.index,
                                error=type(exc).__name__,
                            )
                    self.metrics.record_redispatch()
                    return
                except (ChannelClosedError, TimeoutError):
                    pass  # target gone/wedged: fall through to failing
        self._fail_requests(live, exc)

    def _replica_died(self, rep: _Replica, exc: BaseException) -> None:
        """Permanently remove a replica whose worker thread is gone; every
        batch still queued on its channel fails (or redispatches via the
        batcher's next pick — they are failed here to stay bounded)."""
        rep.dead = True
        self.metrics.record_replica_death()
        runlog.emit("replica_died", replica=rep.index,
                    engine=self.metrics.engine_label, error=repr(exc))
        self.metrics.set_healthy_replicas(self._count_healthy())
        ptlog.error("serving replica %d worker died: %r", rep.index, exc)
        rep.channel.close()
        while True:  # drain: nothing queued may hang its caller (a closed
            item, ok = rep.channel.recv()  # channel's recv never blocks)
            if not ok:
                break
            self._fail_requests(
                item[0], ReplicaDied(f"replica {rep.index} worker died: {exc!r}")
            )

    def _on_alert(self, alert) -> None:
        """Alert-hub action (``anomaly_eject=True``): a per-replica latency
        anomaly trips that replica's breaker — the same ejection/backoff/
        half-open-probe path consecutive FAILURES take, but driven by the
        watch layer's latency detector instead of errors. Never ejects the
        last healthy replica: degraded-but-slow beats down."""
        if alert.source != "watch.serving.replica_exec_seconds":
            return
        if alert.labels.get("engine") != self.metrics.engine_label:
            return
        try:
            index = int(alert.labels.get("replica", ""))
        except ValueError:
            return
        healthy = [r for r in self._replicas
                   if not r.dead and r.breaker.state == "closed"]
        for rep in self._replicas:
            if rep.index != index or rep.dead:
                continue
            if len(healthy) <= 1 and rep in healthy:
                ptlog.warn_once(
                    ("anomaly-eject-last", self.metrics.engine_label, index),
                    "not ejecting replica %d on latency anomaly: it is the "
                    "last healthy replica", index)
                return
            if rep.breaker.trip():
                self.metrics.record_replica_ejection()
                runlog.emit("breaker_open", replica=rep.index,
                            engine=self.metrics.engine_label,
                            error=f"latency anomaly: {alert.message}")
                ptlog.error(
                    "serving replica %d ejected on latency anomaly "
                    "(retry in %.2fs): %s",
                    rep.index, rep.breaker.retry_in(), alert.message)
                self.metrics.set_healthy_replicas(self._count_healthy())
            return

    def _count_healthy(self) -> int:
        return sum(
            1 for r in self._replicas if not r.dead and r.breaker.state == "closed"
        )

    # -- admission / brownout ----------------------------------------------

    def _merged_exec_snapshot(self) -> Optional[dict]:
        """All replicas' execute-latency histograms merged into one
        distribution — the admission controller's deadline-feasibility
        input (registry.quantile reads a single child; exec latencies are
        labeled per replica)."""
        reg = obs_metrics.default_registry()
        return admission_mod.merge_histogram_snapshots([
            reg.histogram_snapshot(
                "serving.replica_exec_seconds",
                {"engine": self.metrics.engine_label,
                 "replica": str(rep.index)})
            for rep in self._replicas
        ])

    def _slo_breached(self) -> bool:
        """Brownout exit probe: True while any SLO on this engine's watcher
        still reports a breach."""
        if self._watcher is None or self._watcher.slo_engine is None:
            return False
        return any(s.get("breached") for s in
                   self._watcher.slo_engine.status())

    def _on_brownout_alert(self, alert) -> None:
        """Alert-hub action (admission enabled): an SLO burn-rate breach on
        this engine enters brownout — warning sheds batch admission,
        critical sheds everything. Exit happens via the probe path in the
        admission controller, not here (alerts are edge-triggered)."""
        if not alert.source.startswith("slo."):
            return
        eng = alert.labels.get("engine")
        if eng is not None and eng != self.metrics.engine_label:
            return
        if self._admission is not None:
            self._admission.enter_brownout(alert.severity,
                                           reason=alert.source)

    @property
    def admission(self) -> Optional[admission_mod.AdmissionController]:
        return self._admission

    def set_brownout(self, severity: str = "warning",
                     reason: str = "manual") -> None:
        """Manually enter brownout (operator override / tests / chaos
        drills) — same shedding path an SLO alert takes."""
        enforce(self._admission is not None,
                "set_brownout requires admission control (configure tenants)")
        self._admission.enter_brownout(severity, reason)

    def clear_brownout(self) -> None:
        if self._admission is not None:
            self._admission.exit_brownout()

    def replica_health(self) -> List[dict]:
        """Per-replica health readout: breaker state + lifetime counters."""
        return [
            dict(index=r.index, dead=r.dead, **r.breaker.snapshot())
            for r in self._replicas
        ]

    @staticmethod
    def _slice_out(out, bucket_b: int, offset: int, n: int):
        """Slice each batched output leaf back to one request's rows
        (non-batched leaves — scalars, globals — pass through whole)."""
        return tree_mod.map_leaves(
            lambda leaf: leaf[offset : offset + n]
            if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == bucket_b
            else leaf,
            out,
        )

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: Optional[float] = None) -> List[str]:
        """Graceful drain: stop intake, flush every accepted request through
        the device, then stop all threads. Idempotent. Returns the names of
        threads that did NOT join within ``timeout`` (empty list = clean
        shutdown) — a wedged worker must be reported, not silently leaked."""
        with self._close_lock:
            if self._closed:
                return []
            self._closed = True
        unjoined: List[str] = []
        self._queue.close()  # batcher drains the buffer, flushes, exits
        self._batcher_thread.join(timeout)
        if self._batcher_thread.is_alive():
            unjoined.append(self._batcher_thread.name)
        for rep in self._replicas:
            rep.channel.close()
        for rep in self._replicas:
            if rep.thread is not None:
                rep.thread.join(timeout)
                if rep.thread.is_alive():
                    unjoined.append(rep.thread.name)
        if unjoined:
            ptlog.error(
                "ServingEngine.close: %d thread(s) failed to join within %s: %s",
                len(unjoined), timeout, ", ".join(unjoined),
            )
        self.metrics.set_queue_depth(0)
        if self._admission is not None:
            admission_mod.uninstall(self._admission)
            if self._watcher is not None:
                self._watcher.hub.unregister_action(self._on_brownout_alert)
        if self._watcher is not None:
            self._watcher.hub.unregister_action(self._on_alert)
            if self._watcher.slo_engine is not None:
                from paddle_tpu_torch.watch import slo as _slo

                _slo.uninstall(self._watcher.slo_engine)
            self._watcher.close()
            self._watcher = None
        return unjoined

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self.close()
        return False
