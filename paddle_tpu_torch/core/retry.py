"""Retry with exponential backoff + jitter — the shared recovery primitive.

Reference: the Go pserver client retried RPCs around its CRC-checked
checkpoint protocol (``go/pserver/client/client.go`` selective re-dial on
connection loss); the C++ side leaned on gRPC's own backoff. Here one
helper owns the policy so checkpoint IO, replica health probes, and any
future flaky-IO path degrade the same way: capped exponential delays with
jitter (decorrelating a fleet of workers hammering shared storage), a
typed allowlist of retryable exceptions, and deterministic behavior when
the caller seeds the rng — fault-injection tests assert exact schedules.

Two storm-control additions layer on top of the plain schedule:

- :func:`decorrelated_backoff` — AWS-style decorrelated jitter. Each
  delay is drawn from ``uniform(base, prev * 3)`` (capped), so a fleet of
  retriers that failed at the same instant spreads out instead of
  re-synchronizing on the shared exponential ladder. ``retry_call``
  switches to it with ``decorrelated=True``; the serving recovery path
  uses it directly between faulted decode iterations.
- :class:`RetryBudget` — a process-wide token bucket spent by retries
  (never by first attempts). When a correlated failure makes *everything*
  retry at once, the budget caps the aggregate retry rate: once dry,
  ``retry_call`` re-raises immediately instead of sleeping and hammering
  the failed dependency. The default budget is shared by checkpoint IO
  and any caller passing ``budget="default"``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple, Type, Union

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "RetryBudget",
    "backoff_delays",
    "decorrelated_backoff",
    "default_budget",
    "next_backoff",
    "retry_call",
    "set_default_budget",
]


def next_backoff(
    attempt: int,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
) -> float:
    """Delay before retry number ``attempt`` (0-based): ``base * 2**attempt``
    capped at ``max_delay``, then stretched by up to ``jitter`` fraction.
    With ``rng=None`` the jitter draw comes from a module-default seeded
    generator, so schedules are reproducible run-to-run."""
    enforce(attempt >= 0, f"attempt must be >= 0, got {attempt}")
    d = min(max_delay, base_delay * (2.0 ** attempt))
    if jitter > 0.0:
        r = rng if rng is not None else _default_rng
        d *= 1.0 + jitter * r.random()
    return d


# deterministic default: a fixed seed keeps un-seeded call sites reproducible
_default_rng = random.Random(0x5EED)


def decorrelated_backoff(
    prev_delay: float,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    rng: Optional[random.Random] = None,
) -> float:
    """Next delay under decorrelated jitter: ``uniform(base, prev * 3)``
    capped at ``max_delay`` (pass ``prev_delay=0`` for the first retry,
    which yields ``base_delay``). Unlike the exponential ladder, two
    retriers that failed together draw from widening, overlapping ranges
    and drift apart instead of colliding on every rung."""
    enforce(prev_delay >= 0.0, f"prev_delay must be >= 0, got {prev_delay}")
    if prev_delay <= 0.0:
        return min(max_delay, base_delay)
    r = rng if rng is not None else _default_rng
    hi = max(base_delay, prev_delay * 3.0)
    return min(max_delay, base_delay + (hi - base_delay) * r.random())


class RetryBudget:
    """Token bucket spent by retries (thread-safe, never blocks). A
    correlated failure — shared filesystem down, device wedged — makes
    every caller's retry loop fire at once; the budget converts that
    amplification into a bounded aggregate retry rate. First attempts are
    never charged: the budget only decides whether a FAILED call may try
    again or must surface its error now.

    ``clock`` is injectable so tests drive refill without sleeping."""

    def __init__(self, rate_per_s: float = 4.0, burst: float = 32.0,
                 clock: Callable[[], float] = time.monotonic):
        enforce(rate_per_s >= 0.0,
                f"rate_per_s must be >= 0, got {rate_per_s}")
        enforce(burst > 0.0, f"burst must be > 0, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = locks.Lock("core.retry_budget")
        self.taken_total = 0
        self.exhausted_total = 0

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                self.taken_total += 1
                return True
            self.exhausted_total += 1
            return False

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self._tokens + (now - self._last) * self.rate)


# the process-wide budget shared by checkpoint IO (and anyone passing
# budget="default"): generous enough that healthy jitter never hits it,
# small enough that a broken dependency can't be hammered indefinitely
_default_budget = RetryBudget(rate_per_s=4.0, burst=32.0)


def default_budget() -> RetryBudget:
    return _default_budget


def set_default_budget(budget: RetryBudget) -> RetryBudget:
    """Swap the process-wide budget (tests); returns the previous one."""
    global _default_budget
    previous, _default_budget = _default_budget, budget
    return previous


def backoff_delays(
    retries: int,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Yield the ``retries`` successive sleep delays of one retry loop."""
    for attempt in range(retries):
        yield next_backoff(attempt, base_delay, max_delay, jitter, rng)


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    retries: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    decorrelated: bool = False,
    budget: Union[RetryBudget, str, None] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    what: Optional[str] = None,
    **kwargs: Any,
):
    """Call ``fn(*args, **kwargs)``, retrying up to ``retries`` times on any
    exception in ``retry_on`` (``retries + 1`` attempts total). Non-listed
    exceptions propagate immediately; the last listed exception propagates
    once attempts are exhausted. ``on_retry(attempt, exc, delay)`` observes
    each retry (tests, metrics); ``sleep`` is injectable so unit tests run
    without wall-clock waits.

    ``decorrelated=True`` draws delays from :func:`decorrelated_backoff`
    instead of the exponential ladder (storm decorrelation). ``budget``
    (a :class:`RetryBudget`, or ``"default"`` for the process-wide one)
    charges one token per retry; when the bucket is dry the caught
    exception re-raises immediately — under a correlated outage the
    process stops amplifying instead of queueing sleeps."""
    from paddle_tpu_torch.core import logging as ptlog
    from paddle_tpu_torch.core import profiler as prof

    enforce(retries >= 0, f"retries must be >= 0, got {retries}")
    label = what or getattr(fn, "__name__", "call")
    if budget == "default":
        budget = _default_budget
    prev_delay = 0.0
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= retries:
                raise
            if budget is not None and not budget.try_take():
                prof.inc_counter("retry.budget_exhausted_total")
                ptlog.warning(
                    "%s failed (%s: %s); retry budget exhausted, not retrying",
                    label, type(e).__name__, e,
                )
                raise
            if decorrelated:
                delay = decorrelated_backoff(prev_delay, base_delay,
                                             max_delay, rng)
            else:
                delay = next_backoff(attempt, base_delay, max_delay, jitter,
                                     rng)
            prev_delay = delay
            ptlog.warning(
                "%s failed (%s: %s); retry %d/%d in %.3fs",
                label, type(e).__name__, e, attempt + 1, retries, delay,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
