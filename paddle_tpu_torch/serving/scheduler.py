"""Weighted fair scheduling over per-tenant request queues.

A copy of ``paddle_tpu.serving.scheduler`` (jax-free) for the PyTorch port.

The serving engine used to drain one global FIFO ``Channel`` — a
single-tenant design where any one client could occupy every queue slot
and every batch. The reference stack had the same failure mode: the gRPC
``listen_and_serv`` server queued sends unboundedly per connection with no
notion of whose work was whose. :class:`WeightedFairScheduler` replaces
the FIFO with one bounded queue per ``(tenant, class)`` drained by deficit
round-robin:

- **Tenants** each carry a *weight*; over time a backlogged tenant is
  served rows in proportion to its weight (classic DRR: each tenant
  accrues a row *deficit* per scheduling round and spends it on its queued
  requests, so fairness is by rows — the unit of device time — not by
  request count).
- **Priority classes**: ``interactive`` requests preempt ``batch`` at
  group-formation time (the scheduler hands interactive work to the
  micro-batcher first), but batch is guaranteed a minimum drain share
  (``batch_min_share``): at least one of every ``1/batch_min_share`` picks
  goes to batch while batch work is pending, so a saturating interactive
  tenant can never starve batch completely.
- **Prompt expiry**: requests whose deadline lapses while queued are
  evicted at the queue head (and en-masse under quota pressure) instead of
  occupying bounded capacity until dispatch discovers them.

The scheduler is deliberately Channel-shaped — ``send`` / ``recv`` /
``close`` / ``qsize`` with ``(value, ok)`` recv semantics and
:class:`~paddle_tpu_torch.concurrency.ChannelClosedError` on send-after-close —
so a channel's consumer drains it unchanged and ``engine.close()`` keeps its
graceful-drain contract.
``send`` preserves the legacy blocking-backpressure contract (used when
admission control is off); :meth:`try_put` is the non-blocking admission
path that reports a quota-rejection reason instead of ever blocking the
caller.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.concurrency import ChannelClosedError
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "INTERACTIVE",
    "BATCH",
    "CLASSES",
    "WeightedFairScheduler",
]

INTERACTIVE = "interactive"
BATCH = "batch"
CLASSES = (INTERACTIVE, BATCH)

# quota-rejection reasons returned by try_put (admission turns them into
# typed AdmissionRejected errors)
REASON_QUEUE_QUOTA = "queue_quota"
REASON_BYTE_QUOTA = "byte_quota"


class _TenantState:
    """One tenant's queues + DRR accounting (all access under the
    scheduler lock)."""

    __slots__ = ("config", "queues", "deficit", "queued", "queued_bytes")

    def __init__(self, config):
        self.config = config
        self.queues: Dict[str, collections.deque] = {
            c: collections.deque() for c in CLASSES
        }
        self.deficit: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self.queued = 0          # requests across both classes
        self.queued_bytes = 0    # payload bytes across both classes


class WeightedFairScheduler:
    """Per-tenant queues + deficit-round-robin drain (see module docstring).

    ``tenants`` maps name -> :class:`~paddle_tpu_torch.serving.admission.
    TenantConfig`. ``quantum_rows`` is the DRR quantum (rows granted to the
    highest-weight tenant per scheduling round); the engine passes its max
    batch size so one quantum always covers one maximal request.
    ``legacy_capacity`` enables the blocking single-FIFO contract for
    ``send`` (total queued requests bounded, callers park) — the
    compatibility mode used when admission control is off.
    ``on_expired(req)`` is invoked (outside the lock) for every request
    evicted because its deadline lapsed in the queue.
    """

    def __init__(
        self,
        tenants: Dict[str, Any],
        *,
        quantum_rows: int = 8,
        batch_min_share: float = 0.1,
        legacy_capacity: Optional[int] = None,
        on_expired: Optional[Callable[[Any], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        enforce(bool(tenants), "scheduler needs at least one tenant")
        enforce(quantum_rows >= 1,
                f"quantum_rows must be >= 1, got {quantum_rows}")
        enforce(0.0 < batch_min_share < 1.0,
                f"batch_min_share must be in (0, 1), got {batch_min_share}")
        self._tenants: Dict[str, _TenantState] = {
            name: _TenantState(cfg) for name, cfg in tenants.items()
        }
        for name, st in self._tenants.items():
            enforce(st.config.weight > 0,
                    f"tenant {name!r}: weight must be > 0")
        self._order: List[str] = list(tenants.keys())
        self._max_weight = max(
            st.config.weight for st in self._tenants.values())
        self._quantum = float(quantum_rows)
        self.batch_min_share = float(batch_min_share)
        # guaranteed batch share: after this many consecutive interactive
        # picks with batch work pending, the next pick is batch
        self._interactive_burst = max(
            1, round((1.0 - batch_min_share) / batch_min_share))
        self._interactive_streak = 0
        self._legacy_capacity = legacy_capacity
        self._on_expired = on_expired
        self._clock = clock
        self._lock = locks.Lock("serving.scheduler")
        self._readable = locks.Condition(self._lock, name="serving.scheduler.readable")  # work available
        self._space = locks.Condition(self._lock, name="serving.scheduler.space")     # capacity freed
        self._rr: Dict[str, int] = {c: 0 for c in CLASSES}
        self._total = 0
        self._closed = False
        self._poked = False

    # -- introspection -----------------------------------------------------

    def qsize(self) -> int:
        with self._lock:
            return self._total

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def poke(self) -> None:
        """Bounce one parked ``recv`` caller out through its timeout path
        without delivering work. The decode-engine loop parks here when
        idle, but handoff/rescue adoptions arrive on side lists only the
        loop thread may touch — without a poke the adoption waits out the
        full idle poll. Only ``recv`` calls WITH a timeout return early;
        an untimed ``recv`` ignores the flag (and leaves it set for the
        next timed caller), so blocking consumers never see a spurious
        ``TimeoutError``."""
        with self._lock:
            self._poked = True
            self._readable.notify()

    def tenant_names(self) -> List[str]:
        return list(self._order)

    def depths(self) -> Dict[str, dict]:
        """Per-tenant queue snapshot: {tenant: {class: depth, ...,
        "bytes": queued_bytes}} — the source for the ``serving.tenant.*``
        queue gauges and the ``/tenants`` endpoint."""
        with self._lock:
            return {
                name: {
                    **{c: len(st.queues[c]) for c in CLASSES},
                    "bytes": st.queued_bytes,
                }
                for name, st in self._tenants.items()
            }

    # -- enqueue -----------------------------------------------------------

    def _req_bytes(self, req) -> int:
        return int(getattr(req, "bytes", 0) or 0)

    def _enqueue_locked(self, st: _TenantState, req) -> None:
        st.queues[req.cls].append(req)
        st.queued += 1
        st.queued_bytes += self._req_bytes(req)
        self._total += 1
        self._readable.notify()

    def try_put(self, req) -> Optional[str]:
        """Non-blocking enqueue for the admission path. Atomically checks
        the tenant's request and byte quotas and enqueues on success.
        Returns None (accepted) or the quota-rejection reason. Expired
        requests already in the tenant's queues are evicted before the
        quota check, so dead work never causes a live rejection. Raises
        :class:`ChannelClosedError` after close."""
        enforce(req.cls in CLASSES,
                f"unknown priority class {req.cls!r} (expected one of {CLASSES})")
        expired: List[Any] = []
        try:
            with self._lock:
                if self._closed:
                    raise ChannelClosedError("scheduler is closed")
                st = self._tenants[req.tenant]
                cfg = st.config
                if st.queued >= cfg.queue_capacity:
                    self._evict_expired_locked(expired, tenant=req.tenant,
                                               full_scan=True)
                if st.queued >= cfg.queue_capacity:
                    return REASON_QUEUE_QUOTA
                nbytes = self._req_bytes(req)
                if cfg.byte_quota and st.queued_bytes + nbytes > cfg.byte_quota:
                    self._evict_expired_locked(expired, tenant=req.tenant,
                                               full_scan=True)
                if cfg.byte_quota and st.queued_bytes + nbytes > cfg.byte_quota:
                    return REASON_BYTE_QUOTA
                self._enqueue_locked(st, req)
                return None
        finally:
            self._fire_expired(expired)

    def send(self, req, timeout: Optional[float] = None) -> None:
        """Blocking enqueue — the legacy bounded-FIFO contract (admission
        off): parks while ``legacy_capacity`` total requests are queued,
        raising ``TimeoutError`` on timeout and
        :class:`ChannelClosedError` if the scheduler is or becomes closed.
        Without a ``legacy_capacity`` the put only bounds per-tenant (the
        admission path should be using :meth:`try_put` instead)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        expired: List[Any] = []
        try:
            with self._lock:
                while True:
                    if self._closed:
                        raise ChannelClosedError("scheduler is closed")
                    cap = self._legacy_capacity
                    if cap is None or self._total < cap:
                        break
                    # free slots held by dead work before parking the caller
                    self._evict_expired_locked(expired, full_scan=True)
                    if self._total < cap:
                        break
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError("scheduler send timed out")
                    self._space.wait(remaining)
                self._enqueue_locked(self._tenants[req.tenant], req)
        finally:
            self._fire_expired(expired)

    # -- expiry ------------------------------------------------------------

    def _pop_locked(self, st: _TenantState, cls: str):
        req = st.queues[cls].popleft()
        st.queued -= 1
        st.queued_bytes -= self._req_bytes(req)
        self._total -= 1
        self._space.notify_all()
        return req

    def _evict_expired_locked(self, out: List[Any],
                              tenant: Optional[str] = None,
                              full_scan: bool = False) -> None:
        """Move expired requests out of the queues into ``out`` (their
        ``on_expired`` callbacks run after the lock is released). Head-only
        by default (O(1) per drain step); ``full_scan`` sweeps whole queues
        — used under quota pressure so an expired request buried mid-queue
        cannot cause a live rejection."""
        now = self._clock()
        names = [tenant] if tenant is not None else self._order
        for name in names:
            st = self._tenants[name]
            for cls in CLASSES:
                q = st.queues[cls]
                while q and q[0].deadline is not None and now > q[0].deadline:
                    out.append(self._pop_locked(st, cls))
                if full_scan and q:
                    live = [r for r in q
                            if r.deadline is None or now <= r.deadline]
                    if len(live) != len(q):
                        for r in q:
                            if r.deadline is not None and now > r.deadline:
                                out.append(r)
                                st.queued -= 1
                                st.queued_bytes -= self._req_bytes(r)
                                self._total -= 1
                        q.clear()
                        q.extend(live)
                        self._space.notify_all()

    def _fire_expired(self, expired: List[Any]) -> None:
        if self._on_expired is not None:
            for req in expired:
                self._on_expired(req)

    # -- drain (DRR + priority) --------------------------------------------

    def _has_work_locked(self, cls: str) -> bool:
        return any(st.queues[cls] for st in self._tenants.values())

    def _choose_class_locked(self) -> Optional[str]:
        has_i = self._has_work_locked(INTERACTIVE)
        has_b = self._has_work_locked(BATCH)
        if has_i and has_b:
            # interactive preempts batch — except for batch's guaranteed
            # minimum share, granted one pick per interactive burst
            if self._interactive_streak >= self._interactive_burst:
                self._interactive_streak = 0
                return BATCH
            self._interactive_streak += 1
            return INTERACTIVE
        if has_i:
            return INTERACTIVE
        if has_b:
            self._interactive_streak = 0
            return BATCH
        return None

    def _pick_from_class_locked(self, cls: str):
        """Deficit round-robin: serve the current tenant while its deficit
        covers its head request's rows; grant weighted quanta to every
        backlogged tenant when no deficit suffices. Terminates because
        quanta are positive and request rows are bounded."""
        order = self._order
        n = len(order)
        while True:
            for k in range(n):
                idx = (self._rr[cls] + k) % n
                st = self._tenants[order[idx]]
                q = st.queues[cls]
                if not q:
                    st.deficit[cls] = 0.0  # classic DRR: idle queues reset
                    continue
                if st.deficit[cls] >= q[0].n:
                    req = self._pop_locked(st, cls)
                    st.deficit[cls] -= req.n
                    if not q:
                        st.deficit[cls] = 0.0
                        self._rr[cls] = (idx + 1) % n
                    else:
                        self._rr[cls] = idx  # keep draining this tenant
                    return req
            for name in order:
                st = self._tenants[name]
                if st.queues[cls]:
                    st.deficit[cls] += (
                        self._quantum * st.config.weight / self._max_weight)

    def recv(self, timeout: Optional[float] = None):
        """Next request by scheduling policy as ``(req, True)``; blocks
        until work arrives, the timeout lapses (``TimeoutError``), or the
        scheduler is closed AND drained (``(None, False)`` — Go's
        ``v, ok``, matching :class:`~paddle_tpu_torch.concurrency.Channel` so the
        micro-batcher's drain loop works unchanged)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            expired: List[Any] = []
            result: Optional[Tuple[Any, bool]] = None
            timed_out = False
            with self._lock:
                self._evict_expired_locked(expired)
                cls = self._choose_class_locked()
                if cls is not None:
                    result = (self._pick_from_class_locked(cls), True)
                elif self._closed:
                    result = (None, False)
                else:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        timed_out = True
                    elif deadline is not None and self._poked:
                        self._poked = False
                        timed_out = True  # poke(): out-of-band work waits
                    elif not expired:
                        # with evicted requests in hand, skip the wait:
                        # their on_expired callbacks must fire now (outside
                        # the lock), not at the next notify — a caller
                        # blocked on one of those requests may be the only
                        # thing that would ever notify again
                        self._readable.wait(remaining)
            self._fire_expired(expired)
            if result is not None:
                return result
            if timed_out:
                raise TimeoutError("scheduler recv timed out")

    def close(self) -> None:
        """Stop intake; queued requests remain drainable via ``recv``
        (graceful drain), parked legacy senders raise. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._readable.notify_all()
            self._space.notify_all()

    def __iter__(self):
        while True:
            value, ok = self.recv()
            if not ok:
                return
            yield value
