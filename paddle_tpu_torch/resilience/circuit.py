"""Circuit breaker: consecutive-failure trip, timed half-open probes.

The serving engine keeps one breaker per device replica so a sick replica
(hung runtime, OOM loop, flaky interconnect) is ejected from rotation
instead of failing every Nth batch forever — the engine degrades to fewer
replicas and keeps serving. States follow the classic pattern:

- ``CLOSED``   — healthy; every dispatch allowed. ``failure_threshold``
  CONSECUTIVE failures trip to OPEN (one success resets the count).
- ``OPEN``     — ejected; dispatches denied until the cooldown elapses.
  Successive re-trips back off exponentially (schedule from
  ``paddle_tpu_torch.core.retry.next_backoff`` — same policy as checkpoint IO
  retries, jitter decorrelates probes across replicas).
- ``HALF_OPEN``— cooldown elapsed; exactly ONE probe dispatch is allowed
  through. Success closes the breaker, failure re-opens it with a longer
  cooldown.

``clock`` is injectable so tests drive the state machine without sleeping.
Thread-safe: dispatchers and workers call in concurrently.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.retry import next_backoff

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 1.0,
        max_cooldown_s: float = 30.0,
        jitter: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        enforce(failure_threshold >= 1,
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = rng
        self._lock = locks.Lock("resilience.circuit_breaker")
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_count = 0     # successive trips without a success between
        self._retry_at = 0.0     # when OPEN may yield a half-open probe
        self.trips_total = 0
        self.recoveries_total = 0

    # -- readout -----------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive_failures

    def retry_in(self) -> float:
        """Seconds until an OPEN breaker would allow a probe (0 otherwise)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._retry_at - self._clock())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "trips_total": self.trips_total,
                "recoveries_total": self.recoveries_total,
                "retry_in_s": (
                    max(0.0, self._retry_at - self._clock())
                    if self._state == OPEN
                    else 0.0
                ),
            }

    # -- state transitions -------------------------------------------------

    def allow(self) -> bool:
        """May a dispatch go to this target right now? CLOSED → yes.
        OPEN → yes exactly once after the cooldown elapses (the call itself
        takes the HALF_OPEN probe token). HALF_OPEN → no (a probe is already
        in flight)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() >= self._retry_at:
                self._state = HALF_OPEN
                return True  # this caller carries the probe
            return False

    def force_allow(self) -> None:
        """Used when EVERY target is open: take the probe slot immediately
        rather than failing all traffic (degraded mode keeps probing)."""
        with self._lock:
            if self._state == OPEN:
                self._state = HALF_OPEN

    def record_success(self) -> bool:
        """A dispatch succeeded. Returns True when this success RECOVERED
        the breaker (it was half-open/open), so callers can log/count
        re-admission exactly once."""
        with self._lock:
            recovered = self._state != CLOSED
            self._state = CLOSED
            self._consecutive_failures = 0
            self._open_count = 0
            if recovered:
                self.recoveries_total += 1
            return recovered

    def trip(self) -> bool:
        """Force the breaker OPEN regardless of the failure count — the
        hook ``paddle_tpu.watch`` alerts use to eject a replica whose
        *latency* (not error rate) went anomalous. Counted as a trip and
        subject to the same backoff schedule as failure-driven trips.
        Returns True when this call performed the CLOSED/HALF_OPEN → OPEN
        transition (False when already OPEN)."""
        with self._lock:
            if self._state == OPEN:
                return False
            self._state = OPEN
            self._retry_at = self._clock() + next_backoff(
                self._open_count,
                base_delay=self.cooldown_s,
                max_delay=self.max_cooldown_s,
                jitter=self.jitter,
                rng=self._rng,
            )
            self._open_count += 1
            self.trips_total += 1
            return True

    def record_failure(self) -> bool:
        """A dispatch failed. Returns True when this failure TRIPPED the
        breaker open (threshold reached, or a half-open probe failed)."""
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                tripped = True  # failed probe: straight back to OPEN
            elif self._state == CLOSED:
                tripped = self._consecutive_failures >= self.failure_threshold
            else:
                return False  # already OPEN (late failure from an old batch)
            if tripped:
                self._state = OPEN
                self._retry_at = self._clock() + next_backoff(
                    self._open_count,
                    base_delay=self.cooldown_s,
                    max_delay=self.max_cooldown_s,
                    jitter=self.jitter,
                    rng=self._rng,
                )
                self._open_count += 1
                self.trips_total += 1
            return tripped
