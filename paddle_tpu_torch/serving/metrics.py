"""Decode-serving observability: the continuous-batching engine's counters,
gauges and latency histograms, port of ``paddle_tpu.serving.metrics``'s
:class:`DecodeMetrics`.

Everything mirrors into the typed registry
(:func:`paddle_tpu_torch.observability.metrics.default_registry`) under the
JAX package's ``serving.decode.*``, ``serving.recovery.*`` and
``serving.tenant.*`` family names, each child labeled with the engine
(``engine="decode0"``, ...), so two engines in one process never collide.
:meth:`DecodeMetrics.snapshot` returns the same counts as a plain dict for
tests and scripts. The static engine's ``ServingMetrics`` comes with
``ServingEngine`` (``ROADMAP.md``), and so do the counters of the parts of
the decode engine not ported yet (host tier, handoff, replica groups, the
journal).
"""

from __future__ import annotations

import collections
import itertools
import math
from typing import Dict, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["DecodeMetrics"]

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

    def record_retries_exhausted(self) -> None:
        with self._lock:
            self.retries_exhausted_total += 1
        self._inc("serving.recovery.retries_exhausted_total")

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
                "retries_exhausted_total": self.retries_exhausted_total,
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
                "ttft_observed_total": self.ttft_observed_total,
                "tpot_samples_total": self.tpot_samples_total,
                "mean_step_occupancy": (
                    self.tokens_total / self.steps_total
                    if self.steps_total else 0.0),
            }
