"""Serving observability, port of ``paddle_tpu.serving.metrics``: the
static engine's :class:`ServingMetrics` (request/batch counters, the
queue-depth gauge, a latency reservoir with percentile readout) and the
continuous-batching engine's :class:`DecodeMetrics`.

Everything mirrors into the typed registry
(:func:`paddle_tpu_torch.observability.metrics.default_registry`) under the
JAX package's ``serving.*``, ``serving.decode.*``, ``serving.recovery.*``
(step faults, recovery, migration, the request journal),
``serving.host_tier.*`` (the host KV tier), ``serving.disagg.*`` (the
prefill/decode handoff) and ``serving.tenant.*`` family names, each child
labeled with the engine (``engine="serving0"``, ``engine="decode1"``, ...
from one sequence per process, as in the JAX package), so two engines in
one process never collide. ``snapshot()`` returns the same counts as a
plain dict, with the JAX package's keys, for tests and scripts. The
``serving.group.*`` families of replica groups come with their port
(``ROADMAP.md`` §A item 4c).
"""

from __future__ import annotations

import collections
import itertools
import math
from typing import Dict, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["ServingMetrics", "DecodeMetrics"]

# distinct default engine labels for every engine built in this process
_ENGINE_SEQ = itertools.count()

# sub-millisecond to 10s — serving latencies, finer than the generic default
_LATENCY_BUCKETS = obs_metrics.exponential_buckets(0.0005, 2.0, 15)


def _percentile(sorted_values, q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_values:
        return 0.0
    rank = max(1, math.ceil(q / 100.0 * len(sorted_values)))
    return sorted_values[rank - 1]


class ServingMetrics:
    """Thread-safe counters for one engine instance."""

    def __init__(self, latency_window: int = 8192,
                 engine_label: Optional[str] = None):
        self._lock = locks.Lock("serving.metrics")
        self.engine_label = engine_label or f"serving{next(_ENGINE_SEQ)}"
        self._labels = {"engine": self.engine_label}
        obs_metrics.default_registry().histogram(
            "serving.request_latency_seconds",
            help="End-to-end request latency (submit to response).",
            buckets=_LATENCY_BUCKETS)
        obs_metrics.default_registry().histogram(
            "serving.batch_occupancy",
            help="Real rows / bucket rows per dispatched batch.",
            buckets=obs_metrics.linear_buckets(0.1, 0.1, 10))
        obs_metrics.default_registry().histogram(
            "serving.replica_exec_seconds",
            help="Per-replica device execute duration per batch.",
            buckets=_LATENCY_BUCKETS)
        obs_metrics.default_registry().histogram(
            "serving.tenant.request_latency_seconds",
            help="End-to-end request latency per tenant and priority class.",
            buckets=_LATENCY_BUCKETS)
        self.requests_total = 0
        self.responses_total = 0
        self.timeouts_total = 0
        self.errors_total = 0
        self.batches_total = 0
        self.rows_total = 0          # real rows dispatched (excl. padding)
        self.padded_rows_total = 0   # zero rows added by bucketing
        self.padded_batches_total = 0  # batches where bucket_b > rows
        self.warmup_executables = 0
        self.dispatch_shapes: set = set()  # distinct (sig, bucket_b) sent
        # replica health (circuit breaker / worker-death accounting)
        self.replica_ejections_total = 0   # breaker trips
        self.replica_recoveries_total = 0  # half-open probes that re-admitted
        self.replica_deaths_total = 0      # worker threads that exited
        self.redispatches_total = 0        # failed batches retried elsewhere
        # multi-tenant admission accounting (serving.tenant.* families)
        self._tenant_admitted: collections.Counter = collections.Counter()
        self._tenant_shed: collections.Counter = collections.Counter()
        self.retries_total = 0                  # submit() retry attempts
        self.retry_budget_exhausted_total = 0   # retries refused by budget
        self._latencies = collections.deque(maxlen=latency_window)

    # -- recorders (called from engine/batcher/worker threads) -------------

    def record_submit(self, rows: int, queue_depth: int) -> None:
        with self._lock:
            self.requests_total += 1
        prof.inc_counter("serving.requests_total", labels=self._labels)
        prof.set_gauge("serving.queue_depth", queue_depth, labels=self._labels)

    def record_batch(self, rows: int, bucket_rows: int, sig) -> None:
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
            self.padded_rows_total += bucket_rows - rows
            if bucket_rows > rows:
                self.padded_batches_total += 1
            self.dispatch_shapes.add((sig, bucket_rows))
        prof.inc_counter("serving.batches_total", labels=self._labels)
        prof.inc_counter("serving.rows_total", rows, labels=self._labels)
        prof.set_gauge("serving.last_batch_occupancy", rows / bucket_rows,
                       labels=self._labels)
        prof.observe("serving.batch_occupancy", rows / bucket_rows,
                     labels=self._labels)

    def record_response(self, latency_s: float) -> None:
        with self._lock:
            self.responses_total += 1
            self._latencies.append(latency_s)
        prof.inc_counter("serving.responses_total", labels=self._labels)
        prof.observe("serving.request_latency_seconds", latency_s,
                     labels=self._labels)

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts_total += 1
        prof.inc_counter("serving.timeouts_total", labels=self._labels)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors_total += n
        prof.inc_counter("serving.errors_total", n, labels=self._labels)

    def record_warmup(self, n: int = 1) -> None:
        with self._lock:
            self.warmup_executables += n
        prof.inc_counter("serving.warmup_executables", n, labels=self._labels)

    def set_queue_depth(self, depth: int) -> None:
        prof.set_gauge("serving.queue_depth", depth, labels=self._labels)

    def record_exec(self, replica: int, seconds: float) -> None:
        """Per-replica device execute duration — the series the watch
        layer's per-replica latency anomaly rule subscribes to."""
        prof.observe("serving.replica_exec_seconds", seconds,
                     labels={**self._labels, "replica": str(replica)})

    def record_replica_ejection(self) -> None:
        with self._lock:
            self.replica_ejections_total += 1
        prof.inc_counter("serving.replica_ejections_total", labels=self._labels)

    def record_replica_recovery(self) -> None:
        with self._lock:
            self.replica_recoveries_total += 1
        prof.inc_counter("serving.replica_recoveries_total", labels=self._labels)

    def record_replica_death(self) -> None:
        with self._lock:
            self.replica_deaths_total += 1
        prof.inc_counter("serving.replica_deaths_total", labels=self._labels)

    def record_redispatch(self) -> None:
        with self._lock:
            self.redispatches_total += 1
        prof.inc_counter("serving.redispatches_total", labels=self._labels)

    def set_healthy_replicas(self, n: int) -> None:
        prof.set_gauge("serving.healthy_replicas", n, labels=self._labels)

    # -- multi-tenant admission (serving.tenant.* families) -----------------

    def record_admit(self, tenant: str, cls: str) -> None:
        with self._lock:
            self._tenant_admitted[(tenant, cls)] += 1
        prof.inc_counter("serving.tenant.admitted_total",
                         labels={**self._labels, "tenant": tenant,
                                 "cls": cls})

    def record_shed(self, tenant: str, cls: str, reason: str) -> None:
        with self._lock:
            self._tenant_shed[(tenant, cls, reason)] += 1
        prof.inc_counter("serving.tenant.shed_total",
                         labels={**self._labels, "tenant": tenant,
                                 "cls": cls, "reason": reason})

    def record_tenant_response(self, tenant: str, cls: str,
                               latency_s: float) -> None:
        prof.observe("serving.tenant.request_latency_seconds", latency_s,
                     labels={**self._labels, "tenant": tenant, "cls": cls})

    def set_tenant_depths(self, depths: Dict[str, dict]) -> None:
        """Refresh the per-tenant queue gauges from a scheduler
        :meth:`~paddle_tpu_torch.serving.scheduler.WeightedFairScheduler.depths`
        snapshot."""
        for tenant, d in depths.items():
            for cls, depth in d.items():
                if cls == "bytes":
                    prof.set_gauge(
                        "serving.tenant.queued_bytes", depth,
                        labels={**self._labels, "tenant": tenant})
                else:
                    prof.set_gauge(
                        "serving.tenant.queue_depth", depth,
                        labels={**self._labels, "tenant": tenant,
                                "cls": cls})

    def set_brownout_level(self, level: int) -> None:
        prof.set_gauge("serving.brownout_level", level, labels=self._labels)

    def record_retry(self) -> None:
        with self._lock:
            self.retries_total += 1
        prof.inc_counter("serving.retries_total", labels=self._labels)

    def record_retry_budget_exhausted(self) -> None:
        with self._lock:
            self.retry_budget_exhausted_total += 1
        prof.inc_counter("serving.retry_budget_exhausted",
                         labels=self._labels)

    def tenant_admitted(self, tenant: str) -> int:
        with self._lock:
            return sum(v for (t, _), v in self._tenant_admitted.items()
                       if t == tenant)

    def tenant_shed(self, tenant: str) -> Dict[str, int]:
        """Shed counts for one tenant, keyed by rejection reason."""
        out: Dict[str, int] = {}
        with self._lock:
            for (t, _, reason), v in self._tenant_shed.items():
                if t == tenant:
                    out[reason] = out.get(reason, 0) + v
        return out

    def shed_total(self) -> int:
        with self._lock:
            return sum(self._tenant_shed.values())

    # -- readout -----------------------------------------------------------

    def mean_batch_occupancy(self) -> float:
        """Mean real rows per dispatched batch — > 1 means the dynamic
        batcher is actually coalescing traffic."""
        with self._lock:
            if self.batches_total == 0:
                return 0.0
            return self.rows_total / self.batches_total

    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._latencies)
        return {
            "p50_ms": _percentile(vals, 50) * 1e3,
            "p99_ms": _percentile(vals, 99) * 1e3,
        }

    def latency_quantile(self, q: float) -> Optional[float]:
        """Estimated request-latency ``q``-quantile in SECONDS from the
        ``serving.request_latency_seconds`` histogram (linear interpolation
        within buckets — the same estimator the SLO engine uses). Unlike
        the bounded reservoir behind :meth:`latency_percentiles`, this
        covers every response since engine start. None before any
        response."""
        return obs_metrics.default_registry().quantile(
            "serving.request_latency_seconds", q, labels=self._labels)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._latencies)
            snap = {
                "engine": self.engine_label,
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "timeouts_total": self.timeouts_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "rows_total": self.rows_total,
                "padded_rows_total": self.padded_rows_total,
                "padded_batches_total": self.padded_batches_total,
                "warmup_executables": self.warmup_executables,
                "distinct_dispatch_shapes": len(self.dispatch_shapes),
                "replica_ejections_total": self.replica_ejections_total,
                "replica_recoveries_total": self.replica_recoveries_total,
                "replica_deaths_total": self.replica_deaths_total,
                "redispatches_total": self.redispatches_total,
                "admitted_total": sum(self._tenant_admitted.values()),
                "shed_total": sum(self._tenant_shed.values()),
                "retries_total": self.retries_total,
                "retry_budget_exhausted_total":
                    self.retry_budget_exhausted_total,
                "mean_batch_occupancy": (
                    self.rows_total / self.batches_total
                    if self.batches_total
                    else 0.0
                ),
            }
        snap["p50_ms"] = _percentile(vals, 50) * 1e3
        snap["p99_ms"] = _percentile(vals, 99) * 1e3
        return snap


class DecodeMetrics:
    """Counters/gauges for one continuous-batching decode engine
    (``serving.decode.DecodeEngine``) under ``serving.decode.*`` families.
    Each engine gets an ``engine`` label, histograms register up front,
    ``snapshot`` returns a plain dict for tests and scripts."""

    def __init__(self, engine_label: Optional[str] = None):
        self._lock = locks.Lock("serving.decode_metrics")
        self.engine_label = engine_label or f"decode{next(_ENGINE_SEQ)}"
        self._labels = {"engine": self.engine_label}
        self._reg = reg = obs_metrics.default_registry()
        reg.histogram(
            "serving.decode.step_seconds",
            help="Wall time of one decode iteration (all slots).",
            buckets=_LATENCY_BUCKETS)
        reg.histogram(
            "serving.decode.prefill_chunk_seconds",
            help="Wall time of one prefill chunk.",
            buckets=_LATENCY_BUCKETS)
        reg.histogram(
            "serving.decode.batch_occupancy",
            help="Active slots / max slots per decode iteration.",
            buckets=obs_metrics.linear_buckets(0.1, 0.1, 10))
        reg.histogram(
            "serving.decode.request_latency_seconds",
            help="End-to-end decode request latency (submit to last token).",
            buckets=_LATENCY_BUCKETS)
        reg.histogram(
            "serving.decode.ttft_seconds",
            help="Submit to first generated token per request (queue wait "
                 "+ prefill), by request class.",
            buckets=_LATENCY_BUCKETS)
        reg.histogram(
            "serving.decode.tpot_seconds",
            help="Per-token latency after the first, by request class. "
                 "Speculation-aware: a verify step landing n tokens books "
                 "n samples, so spec on/off distributions are comparable.",
            buckets=obs_metrics.exponential_buckets(0.0001, 2.0, 15))
        reg.histogram(
            "serving.host_tier.promote_seconds",
            help="Wall time to promote one host-tier page into the radix "
                 "tree (CRC verify + device implant + insert).",
            buckets=_LATENCY_BUCKETS)
        self.requests_total = 0
        self.responses_total = 0
        self.tokens_total = 0          # generated tokens across all requests
        self.prefill_chunks_total = 0
        self.steps_total = 0           # decode iterations run
        self.admitted_total = 0        # requests that got a slot
        self.evicted_total = 0         # finished/cancelled slots released
        self.preempted_total = 0       # evicted on page exhaustion, resumable
        self.resumed_total = 0         # preempted requests re-admitted
        self.cancelled_total = 0
        self.timeouts_total = 0
        self.errors_total = 0
        # zero-loss recovery accounting (serving.recovery.* families)
        self.step_faults_total = 0       # poisoned decode/prefill iterations
        self.recovered_total = 0         # requests re-admitted after a fault
        self.retries_exhausted_total = 0  # requests past their retry budget
        self.migrated_total = 0          # requests drained to another engine
        self.journal_records_total = 0   # WAL records appended
        self.journal_replayed_total = 0  # requests resumed from the journal
        # speculative decoding (serving.decode.spec_* families)
        self.verify_steps_total = 0       # draft-and-verify iterations run
        self.spec_tokens_total = 0        # tokens appended by verify steps
        self.spec_drafts_proposed_total = 0  # draft tokens scored
        self.spec_drafts_accepted_total = 0  # draft tokens accepted
        # prefix cache (serving.decode.prefix_* / cow_* families)
        self.prompt_tokens_total = 0      # prompt tokens across admissions
        self.prefix_hit_tokens_total = 0  # prompt tokens served from cache
        self.prefix_saved_chunks_total = 0  # prefill chunks skipped outright
        self.cow_copies_total = 0         # copy-on-write page copies
        # hierarchical KV host tier (serving.host_tier.* families)
        self.host_tier_hits_total = 0     # admissions whose continuation
        #                                   the host tier held (promote queued)
        self.host_promoted_pages_total = 0  # pages implanted tree-ward
        self.host_demoted_pages_total = 0   # pages written through to host
        self.host_quarantined_total = 0     # CRC-failed host pages dropped
        self.host_backpressure_total = 0    # demotes that forced LRU eviction
        # disaggregated prefill/decode (serving.disagg.* families)
        self.handoffs_out_total = 0       # prefilled requests published
        self.handoffs_in_total = 0        # handed-off requests adopted
        # tenant-quota admission accounting (serving.tenant.* families)
        self._tenant_admitted: collections.Counter = collections.Counter()
        self._tenant_shed: collections.Counter = collections.Counter()
        # token-latency waterfall rollup (serving.decode.ttft/tpot families)
        self.ttft_observed_total = 0
        self.tpot_samples_total = 0

    # -- registry writes ---------------------------------------------------

    def _inc(self, name: str, value: float = 1.0, **labels) -> None:
        self._reg.inc(name, value, labels={**self._labels, **labels})

    def _set(self, name: str, value: float, **labels) -> None:
        self._reg.set(name, value, labels={**self._labels, **labels})

    def _observe(self, name: str, value: float, **labels) -> None:
        self._reg.observe(name, value, labels={**self._labels, **labels})

    # -- recorders ---------------------------------------------------------

    def record_submit(self) -> None:
        with self._lock:
            self.requests_total += 1
        self._inc("serving.decode.requests_total")

    def record_slot_admit(self) -> None:
        """A request got a decode slot (iteration-level admission; distinct
        from :meth:`record_admit`, the tenant-quota admission below)."""
        with self._lock:
            self.admitted_total += 1
        self._inc("serving.decode.admitted_total")

    # -- multi-tenant admission interface (the AdmissionController talks to
    # the metrics object it was built with) ---------------------------------

    def record_admit(self, tenant: str, cls: str) -> None:
        with self._lock:
            self._tenant_admitted[(tenant, cls)] += 1
        self._inc("serving.tenant.admitted_total", tenant=tenant, cls=cls)

    def record_shed(self, tenant: str, cls: str, reason: str) -> None:
        with self._lock:
            self._tenant_shed[(tenant, cls, reason)] += 1
        self._inc("serving.tenant.shed_total", tenant=tenant, cls=cls, reason=reason)

    def set_brownout_level(self, level: int) -> None:
        self._set("serving.brownout_level", level)

    def tenant_admitted(self, tenant: str) -> int:
        with self._lock:
            return sum(v for (t, _), v in self._tenant_admitted.items()
                       if t == tenant)

    def tenant_shed(self, tenant: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for (t, _, reason), v in self._tenant_shed.items():
                if t == tenant:
                    out[reason] = out.get(reason, 0) + v
        return out

    def shed_total(self) -> int:
        with self._lock:
            return sum(self._tenant_shed.values())

    def record_evict(self, reason: str) -> None:
        with self._lock:
            self.evicted_total += 1
        self._inc("serving.decode.evicted_total", reason=reason)

    def record_preempt(self) -> None:
        with self._lock:
            self.preempted_total += 1
        self._inc("serving.decode.preempted_total")

    def record_resume(self) -> None:
        with self._lock:
            self.resumed_total += 1
        self._inc("serving.decode.resumed_total")

    def record_cancel(self) -> None:
        with self._lock:
            self.cancelled_total += 1
        self._inc("serving.decode.cancelled_total")

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts_total += 1
        self._inc("serving.decode.timeouts_total")

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors_total += n
        self._inc("serving.decode.errors_total", n)

    def record_step(self, active: int, max_slots: int,
                    seconds: float, new_tokens: int) -> None:
        with self._lock:
            self.steps_total += 1
            self.tokens_total += new_tokens
        self._inc("serving.decode.steps_total")
        self._inc("serving.decode.tokens_total", new_tokens)
        self._observe("serving.decode.step_seconds", seconds)
        self._observe("serving.decode.batch_occupancy", active / max(max_slots, 1))

    def record_prefill_chunk(self, seconds: float) -> None:
        with self._lock:
            self.prefill_chunks_total += 1
        self._inc("serving.decode.prefill_chunks_total")
        self._observe("serving.decode.prefill_chunk_seconds", seconds)

    def record_response(self, latency_s: float) -> None:
        with self._lock:
            self.responses_total += 1
        self._inc("serving.decode.responses_total")
        self._observe("serving.decode.request_latency_seconds", latency_s)

    # -- token-latency waterfall rollup (ttft/tpot families) -----------------

    def record_ttft(self, seconds: float, cls: str = "default") -> None:
        """One request's time-to-first-token (booked by the waterfall on
        the iteration that produced the first generated token)."""
        with self._lock:
            self.ttft_observed_total += 1
        self._observe("serving.decode.ttft_seconds", seconds, cls=cls or "default")

    def record_tpot(self, samples, cls: str = "default") -> None:
        """Book per-token latency samples — one per generated token after
        the first; a multi-token verify iteration passes several equal
        samples (see tracing/waterfall.py)."""
        if not samples:
            return
        with self._lock:
            self.tpot_samples_total += len(samples)
        for s in samples:
            self._observe("serving.decode.tpot_seconds", s, cls=cls or "default")

    # -- speculative decoding (serving.decode.spec_* families) ---------------

    def record_verify_step(self, active: int, max_slots: int, seconds: float,
                           new_tokens: int, drafts_proposed: int,
                           drafts_accepted: int) -> None:
        """One draft-and-verify iteration: counts like a decode step (it
        advances every participating slot at least one token) plus the
        speculation ledger. ``serving.decode.spec_accept_rate`` is the
        cumulative accepted/proposed draft-token ratio."""
        self.record_step(active, max_slots, seconds, new_tokens)
        with self._lock:
            self.verify_steps_total += 1
            self.spec_tokens_total += new_tokens
            self.spec_drafts_proposed_total += drafts_proposed
            self.spec_drafts_accepted_total += drafts_accepted
            proposed = self.spec_drafts_proposed_total
            rate = (self.spec_drafts_accepted_total / proposed
                    if proposed else 0.0)
        self._inc("serving.decode.verify_steps_total")
        self._inc("serving.decode.spec_tokens_total", new_tokens)
        self._set("serving.decode.spec_accept_rate", rate)

    def spec_accept_rate(self) -> float:
        with self._lock:
            if not self.spec_drafts_proposed_total:
                return 0.0
            return (self.spec_drafts_accepted_total
                    / self.spec_drafts_proposed_total)

    def accepted_tokens_per_verify_step(self) -> float:
        with self._lock:
            if not self.verify_steps_total:
                return 0.0
            return self.spec_tokens_total / self.verify_steps_total

    # -- prefix cache (serving.decode.prefix_* families) ---------------------

    def record_prompt_tokens(self, n: int) -> None:
        with self._lock:
            self.prompt_tokens_total += n
        self._inc("serving.decode.prompt_tokens_total", n)

    def record_prefix_hit(self, hit_tokens: int, saved_chunks: int) -> None:
        with self._lock:
            self.prefix_hit_tokens_total += hit_tokens
            self.prefix_saved_chunks_total += saved_chunks
        self._inc("serving.decode.prefix_hit_tokens_total", hit_tokens)

    def record_cow(self, n: int = 1) -> None:
        with self._lock:
            self.cow_copies_total += n
        self._inc("serving.decode.cow_copies_total", n)

    def prefix_saved_frac(self) -> float:
        """Fraction of admitted prompt tokens whose prefill was served from
        the prefix cache."""
        with self._lock:
            if not self.prompt_tokens_total:
                return 0.0
            return self.prefix_hit_tokens_total / self.prompt_tokens_total

    # -- hierarchical KV host tier (serving.host_tier.* families) ------------

    def record_host_hit(self) -> None:
        """An admission's radix miss had its continuation resident in the
        host tier — a promote job was enqueued (the request itself
        prefills as usual; the NEXT hit lands on the card)."""
        with self._lock:
            self.host_tier_hits_total += 1
        self._inc("serving.host_tier.hits_total")

    def record_host_promote(self, seconds: float) -> None:
        """One host page promoted into the radix tree (CRC verify +
        device implant + tree insert), timed: promotion is budgeted per
        loop iteration, so this histogram bounds what it can cost a
        decode step."""
        with self._lock:
            self.host_promoted_pages_total += 1
        self._inc("serving.host_tier.promoted_pages_total")
        self._observe("serving.host_tier.promote_seconds", seconds)

    def record_host_demote(self, pages: int) -> None:
        with self._lock:
            self.host_demoted_pages_total += pages
        self._inc("serving.host_tier.demoted_pages_total", pages)

    def record_host_quarantine(self, n: int = 1) -> None:
        """A host page failed CRC verification at promote time and was
        quarantined — the request re-prefills token-exactly instead."""
        with self._lock:
            self.host_quarantined_total += n
        self._inc("serving.host_tier.quarantined_total", n)

    def record_host_backpressure(self, n: int = 1) -> None:
        """A demote pushed the pool past its byte budget and forced LRU
        eviction; the gauge mirror climbs while the fleet's warm working
        set outgrows host RAM."""
        with self._lock:
            self.host_backpressure_total += n
            total = self.host_backpressure_total
        self._inc("serving.host_tier.backpressure_total", n)
        self._set("serving.host_tier.demote_backpressure", total)

    def set_host_tier_bytes(self, used: int, budget: int) -> None:
        self._set("serving.host_tier.bytes_used", used)
        self._set("serving.host_tier.bytes_budget", budget)

    # -- disaggregated prefill/decode (serving.disagg.* families) ------------

    def record_handoff_out(self) -> None:
        """This engine finished a prefill and published the request's KV
        pages to the router's handoff sink (prefill-worker role)."""
        with self._lock:
            self.handoffs_out_total += 1
        self._inc("serving.disagg.handoffs_out_total")

    def record_handoff_in(self) -> None:
        """This engine adopted a handed-off request's KV pages straight
        into its decode loop (decode-worker role)."""
        with self._lock:
            self.handoffs_in_total += 1
        self._inc("serving.disagg.handoffs_in_total")

    # -- gauges ------------------------------------------------------------

    def set_load(self, load: float) -> None:
        """Live load signal: active slots plus queued/parked work."""
        self._set("serving.decode.load", load)

    def set_queue_depth(self, depth: int) -> None:
        self._set("serving.decode.queue_depth", depth)

    def set_pages(self, in_use: int, free: int) -> None:
        self._set("serving.decode.pages_in_use", in_use)
        self._set("serving.decode.pages_free", free)

    def set_active_slots(self, n: int) -> None:
        self._set("serving.decode.active_slots", n)

    # -- zero-loss recovery (serving.recovery.* families) --------------------

    def record_step_fault(self) -> None:
        with self._lock:
            self.step_faults_total += 1
        self._inc("serving.recovery.step_faults_total")

    def record_recover(self, n: int = 1) -> None:
        with self._lock:
            self.recovered_total += n
        self._inc("serving.recovery.recovered_total", n)

    def record_migrate(self, n: int = 1) -> None:
        with self._lock:
            self.migrated_total += n
        self._inc("serving.recovery.migrated_total", n)

    def record_retries_exhausted(self) -> None:
        with self._lock:
            self.retries_exhausted_total += 1
        self._inc("serving.recovery.retries_exhausted_total")

    def record_journal_records(self, n: int = 1) -> None:
        with self._lock:
            self.journal_records_total += n
        self._inc("serving.recovery.journal_records_total", n)

    def record_journal_replayed(self, n: int = 1) -> None:
        with self._lock:
            self.journal_replayed_total += n
        self._inc("serving.recovery.journal_replayed_total", n)

    def set_consecutive_faults(self, n: int) -> None:
        """Consecutive faulted iterations on this engine; resets to 0 on
        every clean iteration."""
        self._set("serving.recovery.consecutive_faults", n)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "engine": self.engine_label,
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "tokens_total": self.tokens_total,
                "prefill_chunks_total": self.prefill_chunks_total,
                "steps_total": self.steps_total,
                "admitted_total": self.admitted_total,
                "evicted_total": self.evicted_total,
                "preempted_total": self.preempted_total,
                "resumed_total": self.resumed_total,
                "cancelled_total": self.cancelled_total,
                "timeouts_total": self.timeouts_total,
                "errors_total": self.errors_total,
                "step_faults_total": self.step_faults_total,
                "recovered_total": self.recovered_total,
                "migrated_total": self.migrated_total,
                "retries_exhausted_total": self.retries_exhausted_total,
                "journal_records_total": self.journal_records_total,
                "journal_replayed_total": self.journal_replayed_total,
                "verify_steps_total": self.verify_steps_total,
                "spec_tokens_total": self.spec_tokens_total,
                "spec_drafts_proposed_total": self.spec_drafts_proposed_total,
                "spec_drafts_accepted_total": self.spec_drafts_accepted_total,
                "spec_accept_rate": (
                    self.spec_drafts_accepted_total
                    / self.spec_drafts_proposed_total
                    if self.spec_drafts_proposed_total else 0.0),
                "prompt_tokens_total": self.prompt_tokens_total,
                "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
                "prefix_saved_chunks_total": self.prefix_saved_chunks_total,
                "cow_copies_total": self.cow_copies_total,
                "host_tier_hits_total": self.host_tier_hits_total,
                "host_promoted_pages_total": self.host_promoted_pages_total,
                "host_demoted_pages_total": self.host_demoted_pages_total,
                "host_quarantined_total": self.host_quarantined_total,
                "host_backpressure_total": self.host_backpressure_total,
                "handoffs_out_total": self.handoffs_out_total,
                "handoffs_in_total": self.handoffs_in_total,
                "ttft_observed_total": self.ttft_observed_total,
                "tpot_samples_total": self.tpot_samples_total,
                "mean_step_occupancy": (
                    self.tokens_total / self.steps_total
                    if self.steps_total else 0.0),
            }
