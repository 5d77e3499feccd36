"""Instrumented locking discipline: named locks with order-graph deadlock
detection and a process-wide held-locks registry.

A copy of ``paddle_tpu.core.locks`` for the PyTorch port. The framework
is threaded (the decode engine's loop, watch subscribers, async
checkpoint writers, watchdogs, prefetchers, the exporter), and a lock
taken while holding another that the woken side also needs is a deadlock
waiting for its interleaving. This module checks that discipline:

- :class:`Lock` / :class:`RLock` / :class:`Condition` are drop-in
  ``threading`` replacements carrying a *name* (``"serving.scheduler"``).
  When checking is enabled, every acquisition maintains a per-thread
  held-lock stack and a process-wide **lock-order graph**: acquiring B
  while holding A adds the edge A→B. A cycle in that graph means two
  threads can acquire the same locks in opposite orders — a potential
  deadlock — and is reported *the first time the ordering is observed*,
  long before the interleaving that actually wedges: structured record in
  :func:`violations` (both acquisition stacks), counter
  ``locks.order_violations_total``, and a runlog ``alert`` event.
- Re-acquiring a non-reentrant :class:`Lock` on the owning thread is a
  guaranteed self-deadlock; the instrumented path reports it and raises
  instead of blocking forever.
- The **held-locks registry** (:func:`held_snapshot` /
  :func:`render_held_table`) shows every currently held lock with its
  owner thread, hold duration, and blocked-waiter count — rendered by
  ``resilience/watchdog.py`` stall dumps next to the thread stacks and by
  the observability exporter's ``/locks`` debug endpoint.

Checking is ON by default under pytest (``PYTEST_CURRENT_TEST``);
elsewhere it is toggled via ``flags().lock_check`` /
``PADDLE_TPU_LOCK_CHECK=1`` or :func:`set_enabled`. When off,
``acquire``/``release`` delegate straight to the underlying primitive
(one global read on the way through), and the held-locks registry stays
empty.

Graph nodes are lock *names*, not instances: two instances sharing a name
(every ``Channel``'s lock is ``"concurrency.channel"``) collapse into one
node, which is what makes cross-subsystem ordering checkable. The
deliberate blind spot is ordering *between same-named instances* (edges
``A→A`` are skipped) — name such locks distinctly if their relative order
matters.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.core import config

__all__ = [
    "Lock",
    "RLock",
    "Condition",
    "enabled",
    "set_enabled",
    "held_snapshot",
    "render_held_table",
    "graph_snapshot",
    "violations",
    "order_violations",
    "assert_no_violations",
    "max_hold_seconds",
    "reset",
]

# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force checking on/off; ``None`` restores the default resolution
    (``flags().lock_check``, else on under pytest)."""
    global _override
    _override = value


def enabled() -> bool:
    """Is lock-order checking currently active?"""
    ov = _override
    if ov is not None:
        return ov
    if config.flags().lock_check:
        return True
    return "PYTEST_CURRENT_TEST" in os.environ


# ---------------------------------------------------------------------------
# global state (all raw threading primitives here: the checker must never
# instrument itself)
# ---------------------------------------------------------------------------

_meta = threading.Lock()  # guards _graph/_violations/_reported mutations
# thread ident -> stack of (lock, t0_monotonic) pairs. Bare tuples, not
# record objects: this is the per-acquire hot path, and an object
# construction per acquire is measurable at serving rates. Each thread
# mutates only its own list; snapshots copy under the GIL.
_held: Dict[int, List[tuple]] = {}
# src name -> dst name -> _Edge ("src was held while dst was acquired")
_graph: Dict[str, Dict[str, "_Edge"]] = {}
_violations: List[dict] = []
_reported: set = set()  # frozenset of cycle names, one report per cycle

_tls = threading.local()  # .reporting guard: telemetry emits reentrantly


class _Edge:
    __slots__ = ("stack", "thread_name", "count")

    def __init__(self, stack: str, thread_name: str):
        self.stack = stack      # acquisition stack the first time edge seen
        self.thread_name = thread_name
        self.count = 1          # edges recorded (steady state dedups)


def _capture_stack() -> str:
    # drop the locks.py frames so the stack points at the acquiring caller
    frames = traceback.extract_stack()
    while frames and frames[-1].filename == __file__:
        frames.pop()
    return "".join(traceback.format_list(frames[-8:])).rstrip()


def _push_record(lock: "Lock", tid: int) -> None:
    stack = _held.get(tid)
    if stack is None:
        stack = _held[tid] = []
    stack.append((lock, time.monotonic()))


def _pop_record(lock: "Lock", tid: int) -> None:
    stack = _held.get(tid)
    if not stack:
        return
    # normally the top of the stack; tolerate out-of-order releases and
    # enable/disable races by scanning from the top
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] is lock:
            del stack[i]
            return


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS: a path src -> ... -> dst in the order graph, as a name list."""
    seen = set()
    path: List[str] = []

    def walk(node: str) -> bool:
        if node == dst:
            path.append(node)
            return True
        if node in seen:
            return False
        seen.add(node)
        for nxt in _graph.get(node, ()):
            if walk(nxt):
                path.append(node)
                return True
        return False

    if walk(src):
        path.reverse()
        return path
    return None


def _note_edges(lock: "Lock", stack: List[tuple]) -> None:
    """Record held->acquiring edges and detect order cycles. Called BEFORE
    the blocking acquire, so a deadlock-prone ordering is reported even if
    this very acquisition would wedge. Steady state (edge already known)
    is a couple of dict probes with no lock taken."""
    if getattr(_tls, "reporting", False):
        return
    target = lock.name
    pending: List[dict] = []
    for held_lock, _t0 in stack:
        src = held_lock.name
        if src == target:
            continue  # same-name edges skipped (see module docstring)
        dsts = _graph.get(src)
        if dsts is not None and target in dsts:
            continue
        with _meta:
            edges = _graph.setdefault(src, {})
            if target in edges:
                edges[target].count += 1
                continue
            acq_stack = _capture_stack()
            edges[target] = _Edge(acq_stack,
                                  threading.current_thread().name)
            # a NEW edge src->target closes a cycle iff target already
            # reaches src
            path = _find_path(target, src)
            if path is None:
                continue
            cycle = [src] + path  # src -> target -> ... -> src
            key = frozenset(cycle)
            if key in _reported:
                continue
            _reported.add(key)
            first_hop = _graph.get(path[0], {}).get(path[1]) \
                if len(path) > 1 else None
            pending.append({
                "ts": time.time(),
                "cycle": cycle,
                "thread": threading.current_thread().name,
                "stack": acq_stack,
                "other_thread": first_hop.thread_name if first_hop else "?",
                "other_stack": first_hop.stack if first_hop else "",
            })
            _violations.append(pending[-1])
    for v in pending:
        _report(v)


def _report(violation: dict) -> None:
    """Telemetry for one violation — outside ``_meta``, reentrancy-guarded
    (the counter/runlog writes acquire instrumented locks themselves)."""
    _tls.reporting = True
    try:
        from paddle_tpu_torch.core import logging as ptlog
        from paddle_tpu_torch.core import profiler as prof
        from paddle_tpu_torch.observability import runlog

        chain = " -> ".join(violation["cycle"])
        prof.inc_counter("locks.order_violations_total")
        runlog.emit("alert", source="locks", severity="error",
                    key="order_violation", cycle=chain,
                    thread=violation["thread"])
        ptlog.error(
            "lock-order violation (potential deadlock): %s\n"
            "-- this acquisition (thread %s):\n%s\n"
            "-- prior ordering (thread %s):\n%s",
            chain, violation["thread"], violation["stack"],
            violation["other_thread"], violation["other_stack"] or "<unknown>",
        )
    except Exception:
        pass  # diagnostics must never take down the locking path
    finally:
        _tls.reporting = False


def _report_self_deadlock(lock: "Lock") -> None:
    with _meta:
        key = frozenset((lock.name, "<self>"))
        if key in _reported:
            return
        _reported.add(key)
        _violations.append({
            "ts": time.time(),
            "cycle": [lock.name, lock.name],
            "thread": threading.current_thread().name,
            "stack": _capture_stack(),
            "other_thread": threading.current_thread().name,
            "other_stack": "",
            "self_deadlock": True,
        })
        v = _violations[-1]
    _report(v)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _caller_name() -> str:
    """Default lock name: the construction site (file:line)."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        if fr.filename != __file__:
            return f"{os.path.basename(fr.filename)}:{fr.lineno}"
    return "anonymous"


class Lock:
    """Named, instrumented ``threading.Lock``. Drop-in: ``acquire`` /
    ``release`` / ``locked`` / context manager."""

    _reentrant = False
    __slots__ = ("_lock", "name", "_owner", "_depth", "_waiters")

    def __init__(self, name: Optional[str] = None):
        self._lock = self._make()
        self.name = name or _caller_name()
        self._owner: Optional[int] = None  # set only by instrumented path
        self._depth = 0
        self._waiters = 0

    @staticmethod
    def _make():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not enabled():
            return self._lock.acquire(blocking, timeout)
        tid = threading.get_ident()
        if self._owner == tid:
            if self._reentrant:
                got = self._lock.acquire(blocking, timeout)
                if got:
                    self._depth += 1
                return got
            if blocking:
                _report_self_deadlock(self)
                if timeout is None or timeout < 0:
                    raise RuntimeError(
                        f"self-deadlock: thread already holds "
                        f"non-reentrant lock {self.name!r}")
        stack = _held.get(tid)
        if stack:
            _note_edges(self, stack)
        self._waiters += 1
        try:
            got = self._lock.acquire(blocking, timeout)
        finally:
            self._waiters -= 1
        if got:
            self._owner = tid
            self._depth = 1
            if stack is None:
                stack = _held.get(tid)  # re-read: blocked acquires race
                if stack is None:
                    stack = _held[tid] = []
            stack.append((self, time.monotonic()))
        return got

    def release(self) -> None:
        owner = self._owner
        if owner is not None and owner == threading.get_ident():
            if self._depth > 1:
                self._depth -= 1
            else:
                self._depth = 0
                self._owner = None
                _pop_record(self, owner)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class RLock(Lock):
    """Named, instrumented ``threading.RLock``. Provides the
    ``_release_save`` / ``_acquire_restore`` / ``_is_owned`` trio so
    :class:`Condition` fully releases recursive holds across ``wait``."""

    _reentrant = True
    __slots__ = ()

    @staticmethod
    def _make():
        return threading.RLock()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._lock._is_owned():
            return True
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True

    # -- Condition integration --------------------------------------------

    def _release_save(self):
        owner = self._owner
        if owner is not None and owner == threading.get_ident():
            self._owner = None
            self._depth = 0
            _pop_record(self, owner)
        return self._lock._release_save()

    def _acquire_restore(self, state) -> None:
        self._lock._acquire_restore(state)
        if enabled():
            tid = threading.get_ident()
            self._owner = tid
            self._depth = state[0] if isinstance(state, tuple) and state else 1
            _push_record(self, tid)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()


class Condition(threading.Condition):
    """Named ``threading.Condition`` over an instrumented lock. With no
    lock given, an :class:`RLock` is created (stdlib semantics); passing a
    shared :class:`Lock`/:class:`RLock` keeps the usual two-conditions-
    one-lock idiom. ``wait`` releases the held-locks registry entry for
    the duration of the park (the thread holds nothing while waiting)."""

    def __init__(self, lock: Optional[Lock] = None,
                 name: Optional[str] = None):
        if lock is None:
            lock = RLock(name=name or _caller_name())
        self.name = name or getattr(lock, "name", None) or _caller_name()
        super().__init__(lock)


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------


def held_snapshot() -> List[dict]:
    """Every currently held instrumented lock:
    ``{lock, thread, tid, held_s, waiters}``, longest-held first. Thread
    names resolve at snapshot time (never on the acquire hot path)."""
    now = time.monotonic()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, stack in list(_held.items()):
        for lock, t0 in list(stack):
            out.append({
                "lock": lock.name,
                "thread": names.get(tid, "?"),
                "tid": tid,
                "held_s": round(now - t0, 3),
                "waiters": lock._waiters,
            })
    out.sort(key=lambda r: -r["held_s"])
    return out


def render_held_table() -> str:
    """The held-locks registry as an aligned text table (the watchdog
    appends this to stall dumps)."""
    rows = held_snapshot()
    if not rows:
        return "<no instrumented locks held>"
    header = ("lock", "owner thread", "held (s)", "waiters")
    table = [header] + [
        (r["lock"], f"{r['thread']} (id {r['tid']})",
         f"{r['held_s']:.3f}", str(r["waiters"]))
        for r in rows
    ]
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def max_hold_seconds() -> float:
    """Longest current hold across all threads (0.0 when nothing held)."""
    rows = held_snapshot()
    return rows[0]["held_s"] if rows else 0.0


def graph_snapshot() -> Dict[str, Dict[str, int]]:
    """The lock-order graph as ``{src: {dst: times_observed}}``."""
    with _meta:
        return {src: {dst: e.count for dst, e in dsts.items()}
                for src, dsts in _graph.items()}


def violations() -> List[dict]:
    """Raw violation records (cycle, both threads, both stacks)."""
    with _meta:
        return list(_violations)


def order_violations() -> List[Any]:
    """Violations as :class:`~paddle_tpu_torch.analysis.diagnostics.Diagnostic`
    values (code ``lock-order-cycle``), for uniform reporting alongside
    the static analyzers."""
    from paddle_tpu_torch.analysis.diagnostics import Diagnostic

    out = []
    for v in violations():
        chain = " -> ".join(v["cycle"])
        kind = ("self-deadlock" if v.get("self_deadlock")
                else "potential deadlock")
        out.append(Diagnostic(
            "lock-order-cycle",
            f"{kind}: lock order cycle {chain} (thread {v['thread']} vs "
            f"{v['other_thread']}); stacks in locks.violations()",
            where=chain,
        ))
    return out


def assert_no_violations() -> None:
    """Raise with the full report if any order violation was recorded —
    ``chip_smoke.py`` and tests call this at phase boundaries."""
    vs = violations()
    if not vs:
        return
    parts = []
    for v in vs:
        parts.append(
            f"cycle {' -> '.join(v['cycle'])}\n"
            f"-- thread {v['thread']}:\n{v['stack']}\n"
            f"-- thread {v['other_thread']}:\n{v['other_stack'] or '<unknown>'}"
        )
    raise AssertionError(
        f"{len(vs)} lock-order violation(s):\n" + "\n\n".join(parts))


def reset() -> None:
    """Clear the order graph and violation records (test isolation). Held
    stacks are left alone — they belong to live threads."""
    with _meta:
        _graph.clear()
        _violations.clear()
        _reported.clear()
