"""Dynamic micro-batcher: the queue→batch policy loop (a copy of
``paddle_tpu.serving.batcher``).

Pulls requests off a bounded :class:`paddle_tpu_torch.concurrency.Channel`,
groups them by padded shape signature, and flushes a group when either

- its row count reaches ``max_batch_rows`` (a full batch beats latency), or
- its OLDEST request has waited ``max_delay_s`` (latency beats occupancy).

This is the classic dynamic-batching policy pair (max batch size + max
queue delay). Deadline-expired requests are rejected here — before any
device time is spent on them — via the ``on_expired`` callback.

The batcher owns no threads itself: :meth:`run` is a plain loop the engine
puts on one ``concurrency.go`` goroutine. It exits when the request channel
is closed AND drained, flushing every pending group first — that single
rule is what makes ``engine.close()`` a graceful drain.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.concurrency import Channel

__all__ = ["MicroBatcher", "Group"]


class Group:
    """Requests sharing one shape signature, awaiting flush."""

    __slots__ = ("sig", "requests", "rows", "t_first")

    def __init__(self, sig, t_first: float):
        self.sig = sig
        self.requests: List[Any] = []
        self.rows = 0
        self.t_first = t_first


class MicroBatcher:
    def __init__(
        self,
        queue: Channel,
        max_batch_rows: int,
        max_delay_s: float,
        flush: Callable[[Group], None],
        on_expired: Callable[[Any], None],
        clock: Callable[[], float] = time.monotonic,
    ):
        self._queue = queue
        self._max_rows = int(max_batch_rows)
        self._max_delay = float(max_delay_s)
        self._flush = flush
        self._on_expired = on_expired
        self._clock = clock

    def run(self) -> None:
        groups: Dict[Any, Group] = {}
        while True:
            timeout: Optional[float] = None
            if groups:
                due = min(g.t_first for g in groups.values()) + self._max_delay
                timeout = max(1e-4, due - self._clock())
            try:
                req, ok = self._queue.recv(timeout=timeout)
            except TimeoutError:
                req, ok = None, True
            now = self._clock()
            if req is not None:
                if req.deadline is not None and now > req.deadline:
                    self._on_expired(req)
                else:
                    group = groups.get(req.sig)
                    if group is not None and group.rows + req.n > self._max_rows:
                        # the new request would overflow the bucket: ship the
                        # current group and start a fresh one
                        self._flush(groups.pop(req.sig))
                        group = None
                    if group is None:
                        group = groups.setdefault(req.sig, Group(req.sig, now))
                    group.requests.append(req)
                    group.rows += req.n
                    try:
                        # tracing mark: end of the request's queue wait.
                        # perf_counter (the span timebase), NOT self._clock —
                        # tests inject fake clocks for the delay policy.
                        req.t_grouped_pc = time.perf_counter()
                    except AttributeError:
                        pass  # tests batch plain fake objects with __slots__
                    if group.rows >= self._max_rows:
                        self._flush(groups.pop(req.sig))
            # flush whatever has aged past the delay budget
            for sig in [
                s
                for s, g in groups.items()
                if now >= g.t_first + self._max_delay
            ]:
                self._flush(groups.pop(sig))
            if not ok:
                # channel closed and fully drained: final flush, then exit
                for group in groups.values():
                    self._flush(group)
                return
