"""Named locks with a process-wide held-locks registry.

The names of ``paddle_tpu.core.locks`` (``Lock``, ``RLock``,
``Condition``, ``held_snapshot``, ``render_held_table``) over plain
``threading`` primitives. Each lock carries a name, and every held lock is
listed with its owner thread and hold time, which the step watchdog
appends to its stall dumps. The JAX package's lock-order graph (deadlock
detection under pytest) is not ported yet: it comes with the observability
and analysis slice (``ROADMAP.md``).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional

__all__ = ["Lock", "RLock", "Condition", "held_snapshot", "render_held_table"]

# id(lock) -> (lock, owner thread ident, t0 monotonic); each entry is set and
# deleted by the thread that holds the lock (dict item writes are atomic)
_held: Dict[int, tuple] = {}


def _caller_name() -> str:
    """Default lock name: the construction site (file:line)."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        if fr.filename != __file__:
            return f"{os.path.basename(fr.filename)}:{fr.lineno}"
    return "anonymous"


class Lock:
    """Named ``threading.Lock``: ``acquire`` / ``release`` / ``locked`` /
    context manager."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: Optional[str] = None):
        self._lock = self._factory()
        self.name = name or _caller_name()
        self._depth = 0  # changed only by the owning thread

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._depth += 1
            if self._depth == 1:
                _held[id(self)] = (self, threading.get_ident(), time.monotonic())
        return got

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            _held.pop(id(self), None)
        self._lock.release()

    def locked(self) -> bool:
        return self._depth > 0

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class RLock(Lock):
    """Named ``threading.RLock``, with the hooks :class:`Condition` needs to
    release a recursive hold across ``wait``."""

    _factory = staticmethod(threading.RLock)

    def _release_save(self):
        depth, self._depth = self._depth, 0
        _held.pop(id(self), None)
        return self._lock._release_save(), depth

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._lock._acquire_restore(state)
        self._depth = depth
        _held[id(self)] = (self, threading.get_ident(), time.monotonic())

    def _is_owned(self) -> bool:
        return self._lock._is_owned()


class Condition(threading.Condition):
    """Named ``threading.Condition`` over a :class:`Lock` or :class:`RLock`
    (a new :class:`RLock` when none is given, as in the standard library)."""

    def __init__(self, lock: Optional[Lock] = None, name: Optional[str] = None):
        if lock is None:
            lock = RLock(name=name or _caller_name())
        self.name = name or lock.name
        super().__init__(lock)


def held_snapshot() -> List[dict]:
    """Every currently held lock: ``{lock, thread, tid, held_s}``,
    longest-held first."""
    now = time.monotonic()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = [{"lock": lock.name, "thread": names.get(tid, "?"), "tid": tid,
            "held_s": round(now - t0, 3)}
           for lock, tid, t0 in list(_held.values())]
    out.sort(key=lambda r: -r["held_s"])
    return out


def render_held_table() -> str:
    """The held-locks registry as an aligned text table."""
    rows = held_snapshot()
    if not rows:
        return "<no named locks held>"
    header = ("lock", "owner thread", "held (s)")
    table = [header] + [(r["lock"], f"{r['thread']} (id {r['tid']})", f"{r['held_s']:.3f}")
                        for r in rows]
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip() for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
