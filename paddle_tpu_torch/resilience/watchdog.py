"""Step watchdog: diagnose stalls instead of hanging silently.

A wedged training step (deadlocked host thread, a collective waiting on a
dead peer, a stalled device) looks identical to a slow one from the
outside — the reference stack's answer was an operator timeout plus glog;
ours is a monitor thread armed around each step. When an armed region
exceeds ``timeout_s`` the watchdog dumps EVERY thread's Python stack to
the log (the armed thread highlighted) together with the ``core.locks``
held-locks table (who holds what, for how long — the first question a
stall post-mortem asks), bumps the
``resilience.watchdog_stalls`` counter, and invokes ``on_stall`` — it
never kills the step, because a stall that eventually completes must not
be turned into a failure by its own diagnostics. Escalation is the
CALLER's policy. A copy of ``paddle_tpu.resilience.watchdog`` without the
open tracing spans in the dump (tracing is not ported yet).

Usage::

    wd = StepWatchdog(timeout_s=30.0)
    for batch in reader:
        with wd.watch(f"epoch {e} step {s}"):
            out = step_fn(...)
    wd.close()
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import runlog

__all__ = ["StepWatchdog", "dump_all_stacks"]


def dump_all_stacks(highlight_thread_id: Optional[int] = None) -> str:
    """Every live thread's Python stack as one formatted block."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for tid, frame in sorted(sys._current_frames().items()):
        mark = " <-- stalled" if tid == highlight_thread_id else ""
        parts.append(f"--- thread {names.get(tid, '?')} (id {tid}){mark} ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


class StepWatchdog:
    """Arm/disarm a stall timer around critical regions (one at a time —
    a training loop runs steps serially). One dump fires per stalled
    region; the region itself is never interrupted."""

    def __init__(
        self,
        timeout_s: float,
        on_stall: Optional[Callable[[str, float], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        enforce(timeout_s > 0, f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.stalls = 0  # regions that exceeded the timeout
        self._clock = clock
        self._lock = locks.Lock("resilience.watchdog")
        self._cond = locks.Condition(self._lock, name="resilience.watchdog.cond")
        self._armed = None  # (generation, deadline, tag, thread_id, t_start)
        self._gen = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._monitor, daemon=True, name="step-watchdog"
        )
        self._thread.start()

    @contextmanager
    def watch(self, tag: str = "step"):
        self.arm(tag)
        try:
            yield
        finally:
            self.disarm()

    def arm(self, tag: str = "step") -> None:
        with self._cond:
            self._gen += 1
            now = self._clock()
            self._armed = (
                self._gen, now + self.timeout_s, tag,
                threading.get_ident(), now,
            )
            self._cond.notify_all()

    def disarm(self) -> None:
        with self._cond:
            self._armed = None
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._armed = None
            self._cond.notify_all()
        self._thread.join(timeout=5)

    def _monitor(self) -> None:
        while True:
            stall = None
            with self._cond:
                if self._closed:
                    return
                if self._armed is None:
                    # bounded idle wait: a lost close() notify (killed
                    # process, racing shutdown) must not park this thread
                    # forever — re-check _closed each second
                    self._cond.wait(timeout=1.0)
                    continue
                gen, deadline, tag, tid, t_start = self._armed
                now = self._clock()
                if now < deadline:
                    self._cond.wait(deadline - now)
                    continue
                # deadline passed and the same region is still armed: stall.
                # Fire once per region (re-arm happens on the next step).
                self._armed = None
                self.stalls += 1
                stall = (tag, tid, now - t_start)
            # diagnostics + user callback run with NO lock held: they may
            # be slow, and on_stall re-entering arm()/disarm() must not
            # deadlock
            tag, tid, elapsed = stall
            dump = dump_all_stacks(highlight_thread_id=tid)
            prof.inc_counter("resilience.watchdog_stalls")
            held = locks.held_snapshot()
            runlog.emit("watchdog_stall", tag=tag,
                        elapsed_s=round(elapsed, 3), held_locks=held)
            ptlog.error(
                "watchdog: %s exceeded %.1fs (%.1fs elapsed); "
                "thread stacks:\n%s\nheld locks:\n%s",
                tag, self.timeout_s, elapsed, dump,
                locks.render_held_table(),
            )
            if self.on_stall is not None:
                self.on_stall(tag, elapsed)
