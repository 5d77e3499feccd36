"""Span contexts and the in-process span store.

The reference framework correlated host and device activity with CUPTI
inside ``DeviceTracer`` (platform/device_tracer.h): RAII annotations on the
host side, kernel records on the device side, merged into one timeline
protobuf keyed by correlation id. Here (a copy of
``paddle_tpu.tracing.context``) causality is carried explicitly instead. A :class:`SpanContext` — trace_id/span_id/
parent_id, encodable as a W3C ``traceparent`` string — is attached to every
serving request at enqueue and to every training step at fetch, and each
pipeline stage opens a child span against it. The resulting span records
land in a bounded in-memory store that :mod:`paddle_tpu_torch.tracing.export`
merges with profiler spans, runlog events, and device-memory samples into
one Chrome-trace document.

Two timestamp APIs cover the two shapes of instrumentation:

* ``start_span``/``start_trace`` — context managers for code the span
  encloses lexically (the trainer's step phases).
* ``record_span`` — explicit ``time.perf_counter()`` start/end for spans
  whose lifetime crosses threads (a serving request's queue wait is
  measured by the batcher thread against a timestamp taken by the
  submitter).

All span times share the profiler's timebase (``time.perf_counter()``
microseconds) so host spans from both systems line up in one export.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.config import flags
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "SpanContext",
    "Span",
    "start_span",
    "start_trace",
    "record_span",
    "current_context",
    "spans",
    "spans_for_trace",
    "active_spans",
    "phase_totals",
    "validate_trace",
    "reset_tracing",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "pc_us_to_epoch_s",
    "epoch_s_to_pc_us",
]

# One-time offset between the span timebase (perf_counter) and wall-clock
# epoch seconds (the runlog timebase). Computed once at import so every
# conversion in a process is consistent; drift between the two clocks over
# a run is far below span-duration resolution.
_PC_TO_EPOCH_S = time.time() - time.perf_counter()


def pc_us_to_epoch_s(us: float) -> float:
    """perf_counter microseconds -> wall-clock epoch seconds."""
    return us / 1e6 + _PC_TO_EPOCH_S


def epoch_s_to_pc_us(ts: float) -> float:
    """wall-clock epoch seconds -> perf_counter microseconds."""
    return (ts - _PC_TO_EPOCH_S) * 1e6


_TRACEPARENT_VERSION = "00"


class SpanContext:
    """Identity of one span: which trace it belongs to, its own id, and its
    parent's id. Immutable; propagation creates children."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str] = None):
        enforce(
            len(trace_id) == 32 and _is_hex(trace_id),
            f"trace_id must be 32 lowercase hex chars, got {trace_id!r}",
        )
        enforce(
            len(span_id) == 16 and _is_hex(span_id),
            f"span_id must be 16 lowercase hex chars, got {span_id!r}",
        )
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new_trace(cls) -> "SpanContext":
        """A fresh root context (no parent)."""
        return cls(os.urandom(16).hex(), os.urandom(8).hex())

    def child(self) -> "SpanContext":
        """A new context in the same trace, parented to this span."""
        return SpanContext(self.trace_id, os.urandom(8).hex(), self.span_id)

    def to_traceparent(self) -> str:
        """W3C trace-context ``traceparent`` header value
        (``00-<trace_id>-<span_id>-01``; sampled flag always set — the
        store is bounded, sampling-out happens by eviction, not at the
        source)."""
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: str) -> "SpanContext":
        parts = header.strip().split("-")
        enforce(
            len(parts) == 4,
            f"malformed traceparent {header!r}: want version-traceid-spanid-flags",
        )
        version, trace_id, span_id, traceflags = parts
        enforce(
            len(version) == 2 and _is_hex(version) and version != "ff",
            f"malformed traceparent version {version!r}",
        )
        enforce(
            len(traceflags) == 2 and _is_hex(traceflags),
            f"malformed traceparent flags {traceflags!r}",
        )
        enforce(
            trace_id != "0" * 32 and span_id != "0" * 16,
            f"traceparent {header!r} has an all-zero id (invalid per spec)",
        )
        return cls(trace_id, span_id)

    def __repr__(self):
        return (
            f"SpanContext(trace_id={self.trace_id!r}, span_id={self.span_id!r}, "
            f"parent_id={self.parent_id!r})"
        )

    def __eq__(self, other):
        return (
            isinstance(other, SpanContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.parent_id == other.parent_id
        )

    def __hash__(self):
        return hash((self.trace_id, self.span_id, self.parent_id))


def _is_hex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)


class Span:
    """One finished-or-open span record. Mutable while open (``set`` adds
    attributes, ``cancel`` discards it); frozen in the store once closed."""

    __slots__ = ("name", "context", "t0_us", "t1_us", "attrs", "tid",
                 "thread_name", "_cancelled")

    def __init__(self, name: str, context: SpanContext, t0_us: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.context = context
        self.t0_us = t0_us
        self.t1_us: Optional[float] = None
        self.attrs = dict(attrs) if attrs else {}
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self._cancelled = False

    @property
    def duration_s(self) -> Optional[float]:
        if self.t1_us is None:
            return None
        return (self.t1_us - self.t0_us) / 1e6

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def cancel(self) -> None:
        """Discard this span on exit (e.g. the data-wait that hit
        end-of-epoch instead of yielding a batch)."""
        self._cancelled = True

    def __repr__(self):
        dur = f"{self.duration_s * 1e3:.3f}ms" if self.t1_us is not None else "open"
        return f"Span({self.name!r}, {dur}, {self.context.trace_id[:8]}…)"


# --------------------------------------------------------------------------
# Store + thread-local span stack
# --------------------------------------------------------------------------

_lock = locks.Lock("tracing.spans")
_store: "deque[Span]" = deque(maxlen=max(1, int(flags().trace_max_spans)))
_enabled = True
_tls = threading.local()
# Open spans across ALL threads, keyed by id(span) — the watchdog dumps this
# on a stall to show what every thread was inside when it wedged.
_open: Dict[int, Span] = {}


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing() -> None:
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def reset_tracing() -> None:
    """Clear the span store (open spans in flight are unaffected — they
    simply land in the fresh store when they close)."""
    with _lock:
        _store.clear()


def _stack() -> List[Span]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_context() -> Optional[SpanContext]:
    """The SpanContext of this thread's innermost open span, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1].context if st else None


def _resolve_parent(parent) -> Optional[SpanContext]:
    if parent is None:
        return current_context()
    if isinstance(parent, Span):
        return parent.context
    enforce(
        isinstance(parent, SpanContext),
        f"parent must be a Span or SpanContext, got {type(parent).__name__}",
    )
    return parent


def _commit(span: Span) -> None:
    with _lock:
        if len(_store) == _store.maxlen:
            prof.inc_counter("tracing.spans_evicted")
        _store.append(span)


class _SpanScope:
    """Context manager returned by start_span/start_trace."""

    __slots__ = ("_span",)

    def __init__(self, span: Span):
        self._span = span

    def __enter__(self) -> Span:
        _stack().append(self._span)
        _open[id(self._span)] = self._span
        return self._span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        st = _stack()
        # Tolerate exotic unwind orders (generators finalized late): remove
        # this span wherever it sits rather than blindly popping the top.
        for i in range(len(st) - 1, -1, -1):
            if st[i] is span:
                del st[i]
                break
        _open.pop(id(span), None)
        span.t1_us = time.perf_counter() * 1e6
        if exc_type is not None:
            span.attrs.setdefault("status", "error")
            span.attrs.setdefault("exception", exc_type.__name__)
        if _enabled and not span._cancelled:
            _commit(span)
        return False


def start_span(name: str, parent=None, **attrs) -> _SpanScope:
    """Open a span as a child of ``parent`` (a Span or SpanContext), or of
    this thread's current span, or as a new root if neither exists. Usable
    as ``with start_span("trainer.h2d") as sp: ...``."""
    pctx = _resolve_parent(parent)
    ctx = pctx.child() if pctx is not None else SpanContext.new_trace()
    return _SpanScope(Span(name, ctx, time.perf_counter() * 1e6, attrs))


def start_trace(name: str, **attrs) -> _SpanScope:
    """Open a new ROOT span (fresh trace_id) regardless of any span already
    open on this thread — one trace per training step / per request."""
    return _SpanScope(Span(name, SpanContext.new_trace(), time.perf_counter() * 1e6, attrs))


def record_span(
    name: str,
    t0: float,
    t1: float,
    parent=None,
    context: Optional[SpanContext] = None,
    **attrs,
) -> Optional[SpanContext]:
    """Record an already-measured span. ``t0``/``t1`` are
    ``time.perf_counter()`` seconds. With ``context=`` the span is recorded
    under that exact identity (used for a request's root span, whose context
    was minted at submit time); otherwise a child of ``parent`` (or of the
    current thread span) is minted. Returns the span's context, or None when
    tracing is disabled."""
    if not _enabled:
        return None
    enforce(t1 >= t0, f"record_span({name!r}): t1 < t0 ({t1} < {t0})")
    if context is not None:
        ctx = context
    else:
        pctx = _resolve_parent(parent)
        ctx = pctx.child() if pctx is not None else SpanContext.new_trace()
    span = Span(name, ctx, t0 * 1e6, attrs)
    span.t1_us = t1 * 1e6
    _commit(span)
    return ctx


def spans() -> List[Span]:
    """Snapshot of the span store (oldest first)."""
    with _lock:
        return list(_store)


def spans_for_trace(trace_id: str) -> List[Span]:
    """All stored spans of one trace, start-time ordered."""
    with _lock:
        got = [s for s in _store if s.context.trace_id == trace_id]
    got.sort(key=lambda s: s.t0_us)
    return got


def active_spans() -> List[Span]:
    """Currently-open spans across all threads (stall diagnostics)."""
    return list(_open.values())


def phase_totals(names: Iterable[str]) -> Dict[str, float]:
    """Total seconds spent in each named span across the store — the
    per-phase breakdown bench.py reports (data_wait/h2d/compile/step)."""
    want = set(names)
    totals = {n: 0.0 for n in want}
    with _lock:
        for s in _store:
            if s.name in want and s.t1_us is not None:
                totals[s.name] += (s.t1_us - s.t0_us) / 1e6
    return totals


# Child spans may overshoot their parent by measurement skew: the parent's
# endpoints and the child's are captured by different perf_counter() calls,
# sometimes on different threads. Tolerate a small slack before calling a
# tree malformed.
_CONTAINMENT_SLACK_US = 500.0


def validate_trace(trace_spans: List[Span],
                   multi_engine: bool = False) -> List[str]:
    """Structural checks over one trace's spans. Returns a list of problem
    strings — empty means the trace reconstructs end-to-end: exactly one
    root, every parent_id resolves, every span closed and monotonic
    (t1 >= t0), and children sit inside their parent's interval.

    With ``multi_engine=True`` (fleet traces: handoff, migration, crash
    replay) the containment check is skipped for parent/child pairs whose
    ``engine`` attrs differ: a migrated request's pre-adoption spans ran
    on a different engine, before the adopting engine's root interval
    opened — cross-engine edges carry causality, not wall-clock
    containment. Identity checks (one trace id, one root, no orphaned
    parent_ids, closed + monotonic spans) still apply in full."""
    problems: List[str] = []
    if not trace_spans:
        return ["trace has no spans"]
    tids = {s.context.trace_id for s in trace_spans}
    if len(tids) != 1:
        problems.append(f"spans from {len(tids)} different traces: {sorted(tids)}")
    by_id = {s.context.span_id: s for s in trace_spans}
    roots = [s for s in trace_spans if s.context.parent_id is None]
    if len(roots) != 1:
        problems.append(
            f"want exactly 1 root span, got {len(roots)}: "
            f"{[s.name for s in roots]}"
        )
    for s in trace_spans:
        if s.t1_us is None:
            problems.append(f"span {s.name!r} never closed")
            continue
        if s.t1_us < s.t0_us:
            problems.append(f"span {s.name!r} not monotonic: t1 < t0")
        pid = s.context.parent_id
        if pid is None:
            continue
        parent = by_id.get(pid)
        if parent is None:
            problems.append(f"span {s.name!r} has unresolved parent_id {pid}")
            continue
        if parent.t1_us is None:
            continue
        if multi_engine and s.attrs.get("engine") != parent.attrs.get("engine"):
            continue
        if (s.t0_us < parent.t0_us - _CONTAINMENT_SLACK_US
                or s.t1_us > parent.t1_us + _CONTAINMENT_SLACK_US):
            problems.append(
                f"span {s.name!r} [{s.t0_us:.0f},{s.t1_us:.0f}] escapes parent "
                f"{parent.name!r} [{parent.t0_us:.0f},{parent.t1_us:.0f}]"
            )
    return problems
