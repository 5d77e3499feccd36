"""Structured run-event log: append-only JSONL of what the run *did*.

One line per event, each a JSON object carrying at least ``ts`` (unix
seconds), ``kind``, and ``step`` (``null`` when the event is not tied to a
training step). Producers call the module-level :func:`emit` — a no-op
until a :class:`RunLog` is installed via :func:`set_runlog` (usually by
``observability.setup()`` from the ``runlog_path`` flag), so hooks in hot
paths cost one global read when logging is off.

Event kinds the port emits:

- ``step`` — loss, step_time_s, examples_per_sec, EMA throughput, MFU
  (``trainer.py``)
- ``compile`` — an Executor-prepared function's first call at a new
  argument signature, and its seconds (``executor.py``)
- ``checkpoint_save`` / ``checkpoint_restore`` / ``checkpoint_async_write``
  — publish/restore with path and step; the async-write event carries the
  background writer's wall seconds (``checkpoint.py``,
  ``checkpoint_sharded.py``)
- ``nan_skip`` / ``rollback`` / ``watchdog_stall`` / ``fault_injected`` —
  resilience events (``trainer.py``, ``resilience/``)
- ``decode_admit`` / ``decode_evict`` / ... — the decode engine's request
  life cycle (``serving/decode.py``)
- ``alert`` — watch-layer and lock-order alerts with source/key/severity
  (``watch/alerts.py``, ``core/locks.py``)

A copy of ``paddle_tpu.observability.runlog`` (jax-free): the same line
format, so tools that read one package's run log read the other's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import enforce

__all__ = [
    "RunLog", "set_runlog", "get_runlog", "emit", "read_runlog",
    "rotated_paths", "set_context_provider",
]

# Optional callable returning extra fields to stamp on every event — the
# tracing package installs one at import that returns the emitting thread's
# active {trace_id, span_id}, so runlog lines correlate with spans without
# runlog ever importing tracing (which imports observability).
_context_provider = None


def set_context_provider(provider) -> None:
    """Install a ``() -> Optional[dict]`` whose fields are merged into
    every emitted event (explicit fields win). ``None`` clears it."""
    global _context_provider
    _context_provider = provider


def _json_default(obj):
    # numpy / jax scalars and anything else non-JSON: degrade gracefully
    for cast in (float, int):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


class RunLog:
    """Append-only JSONL event sink (thread-safe, line-buffered).

    With ``max_bytes > 0`` the file rolls over by size: when the next line
    would push the active file past ``max_bytes``, it is renamed to
    ``path.1`` (older segments shifting to ``path.2`` … ``path.<keep>``,
    the oldest dropped) and a fresh file is opened. Lines are never split
    across segments, so every segment parses standalone and
    :func:`read_runlog` can stitch them back oldest-first."""

    def __init__(self, path: str, max_bytes: int = 0, keep: int = 3):
        enforce.enforce(bool(path), "RunLog: path must be non-empty")
        enforce.enforce(keep >= 1, f"RunLog: keep must be >= 1, got {keep}")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self._lock = locks.Lock("observability.runlog")
        self._fh = open(path, "a", buffering=1)
        self._size = self._fh.tell()
        self._closed = False
        self.rotations = 0

    def emit(self, kind: str, step: Optional[int] = None, **fields: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "kind": kind, "step": step}
        provider = _context_provider
        if provider is not None:
            try:
                ctx_fields = provider()
            except Exception:
                ctx_fields = None
            if ctx_fields:
                record.update(ctx_fields)
        record.update(fields)
        line = json.dumps(record, default=_json_default) + "\n"
        with self._lock:
            if self._closed:
                return
            if (self.max_bytes > 0 and self._size > 0
                    and self._size + len(line) > self.max_bytes):
                self._rotate_locked()
            self._fh.write(line)
            self._size += len(line)

    def _rotate_locked(self) -> None:
        self._fh.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", buffering=1)
        self._size = 0
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fh.close()


_active: Optional[RunLog] = None
_install_lock = locks.Lock("observability.runlog_install")


def set_runlog(runlog: Optional[RunLog]) -> Optional[RunLog]:
    """Install (or clear, with ``None``) the process-wide run log.
    Returns the previously installed one (not closed)."""
    global _active
    with _install_lock:
        previous, _active = _active, runlog
    return previous


def get_runlog() -> Optional[RunLog]:
    return _active


def emit(kind: str, step: Optional[int] = None, **fields: Any) -> None:
    """Emit to the installed run log; no-op when none is installed."""
    log = _active
    if log is not None:
        log.emit(kind, step=step, **fields)


def rotated_paths(path: str) -> List[str]:
    """Existing segments for ``path``, oldest first: ``path.N`` … ``path.1``
    then ``path`` itself (only the ones present on disk)."""
    rotated = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        rotated.append(f"{path}.{i}")
        i += 1
    out = list(reversed(rotated))
    if os.path.exists(path):
        out.append(path)
    return out


def read_runlog(path: str, include_rotated: bool = True) -> List[Dict[str, Any]]:
    """Parse a runlog back into event dicts, reading rotated segments
    (``path.N`` … ``path.1``) oldest-first before the active file — a
    reader at a rotation boundary sees one continuous stream. Skips blank
    lines; a torn line from a crashed writer raises ``ValueError`` with
    the offending file and line number."""
    paths = rotated_paths(path) if include_rotated else [path]
    if not paths:
        paths = [path]  # nothing on disk: surface the normal FileNotFoundError
    events = []
    for p in paths:
        with open(p) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{p}:{lineno}: invalid runlog line: {e}") from e
    return events
