"""Profiling: counters and gauges, host spans, and ``torch.profiler`` traces.

Port of ``paddle_tpu.core.profiler``. Reference:
``platform/profiler.h:73-91`` (RecordEvent/RecordBlock RAII),
``platform/profiler.cc:476`` aggregation tables, the CUPTI DeviceTracer
(``platform/device_tracer.h:49-103``), and the Python context managers
``python/paddle/fluid/profiler.py:125-221``.

- ``inc_counter``/``set_gauge``/``observe`` delegate to the typed labeled
  registry (:func:`paddle_tpu_torch.observability.metrics.default_registry`)
  that the Prometheus exporter scrapes, labels kept; :func:`counters` and
  :func:`gauges` are the flat views (labeled children summed / the last
  write), and :func:`histograms` the flat ``{count, sum, min, max}`` view.
- ``record_event`` is a ``torch.profiler.record_function`` range (it shows
  in a ``torch.profiler`` trace of the card) and, while
  :func:`enable_profiler` is on, also a host span in the aggregation table
  and the Chrome-trace timeline (:func:`export_chrome_trace`).
- :func:`profiler` / :func:`start_profiler` / :func:`stop_profiler` run a
  ``torch.profiler`` trace with CPU and (when present) CUDA activities and
  write it as a Chrome trace into ``log_dir``, beside the host timeline.
- :func:`cuda_profiler` starts and stops the CUDA runtime profiler around
  a block, as Fluid's did.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from paddle_tpu_torch.core import locks

__all__ = [
    "inc_counter", "set_gauge", "observe", "counters", "gauges", "histograms",
    "reset_metrics", "record_event", "enable_profiler", "disable_profiler",
    "spans", "thread_names", "summary_string", "export_chrome_trace",
    "step_breakdown", "profiler", "start_profiler", "stop_profiler",
    "reset_profiler",
]

_events: Dict[str, list] = defaultdict(list)
# correlated spans for the timeline export: (name, start_us, dur_us, tid)
_spans: list = []
# thread ident -> thread name, captured the first time a span lands on a
# thread so export_chrome_trace can emit ph:"M" thread_name metadata
_thread_names: Dict[int, str] = {}
_MAX_SPANS = 1_000_000
_enabled: bool = False

# histogram extremes for the flat histograms() view (the registry keeps
# buckets, sums and counts per labeled child, not extremes)
_extremes_lock = locks.Lock("core.profiler_extremes")
_extremes: Dict[str, list] = {}


def _registry():
    from paddle_tpu_torch.observability import metrics as obs_metrics

    return obs_metrics.default_registry()


def inc_counter(name: str, value: float = 1.0, labels: Optional[dict] = None) -> None:
    """Add to a named monotonic counter (thread-safe)."""
    _registry().inc(name, value, labels=labels)


def set_gauge(name: str, value: float, labels: Optional[dict] = None) -> None:
    """Set a named gauge to its latest value (thread-safe)."""
    _registry().set(name, value, labels=labels)


def observe(name: str, value: float, labels: Optional[dict] = None) -> None:
    """Record one observation into a named histogram (thread-safe).
    Declare non-default bucket edges up front via
    ``observability.default_registry().histogram(name, buckets=...)``."""
    v = float(value)
    _registry().observe(name, v, labels=labels)
    with _extremes_lock:
        ext = _extremes.setdefault(name, [math.inf, -math.inf])
        ext[0] = min(ext[0], v)
        ext[1] = max(ext[1], v)


def counters() -> Dict[str, float]:
    """Snapshot of all counters (labeled children summed per family)."""
    return _registry().flat_counters()


def gauges() -> Dict[str, float]:
    """Snapshot of all gauges (most recent write per family)."""
    return _registry().flat_gauges()


def histograms() -> Dict[str, Dict[str, float]]:
    """Snapshot of all histograms, labeled children summed per family:
    ``{name: {count, sum, min, max}}``."""
    from paddle_tpu_torch.observability import metrics as obs_metrics

    out: Dict[str, Dict[str, float]] = {}
    for fam in _registry().collect():
        if fam.kind != obs_metrics.HISTOGRAM or not fam.samples:
            continue
        out[fam.name] = {"count": sum(h["count"] for _, h in fam.samples),
                         "sum": sum(h["sum"] for _, h in fam.samples)}
    with _extremes_lock:
        for name, h in out.items():
            lo, hi = _extremes.get(name, (math.inf, -math.inf))
            h["min"], h["max"] = lo, hi
    return out


def reset_metrics() -> None:
    """Clear counters, gauges, and histograms (test isolation)."""
    _registry().reset()
    with _extremes_lock:
        _extremes.clear()


@contextlib.contextmanager
def record_event(name: str) -> Iterator[None]:
    """RAII host annotation (RecordEvent parity): a named range in
    ``torch.profiler`` traces; while :func:`enable_profiler` is on, also a
    host span. Costs one call when neither runs."""
    if not _enabled:
        with torch.profiler.record_function(name):
            yield
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    t1 = time.perf_counter()
    _events[name].append(t1 - t0)
    if len(_spans) < _MAX_SPANS:  # bound timeline memory on long runs
        tid = threading.get_ident()
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
        _spans.append((name, t0 * 1e6, (t1 - t0) * 1e6, tid))
    else:
        # the cap protects memory, but a silently truncated timeline is a
        # debugging trap — count every drop and say so once per window
        inc_counter("profiler.spans_dropped")
        from paddle_tpu_torch.core import logging as ptlog

        ptlog.warn_once(
            "profiler.spans_dropped",
            "profiler: span buffer full (%d spans); further spans dropped — "
            "the exported timeline is truncated (reset_profiler() or export "
            "more often)",
            _MAX_SPANS,
        )


def spans() -> list:
    """Snapshot of recorded host spans as (name, start_us, dur_us, tid) —
    consumed by the merged exporter in ``paddle_tpu_torch.tracing.export``."""
    return list(_spans)


def thread_names() -> Dict[int, str]:
    """Snapshot of the tid → thread-name map captured alongside spans."""
    return dict(_thread_names)


def enable_profiler() -> None:
    global _enabled
    _enabled = True
    _events.clear()
    _spans.clear()


def disable_profiler() -> Dict[str, Dict[str, float]]:
    """Stop host profiling and return the aggregation table
    (name → {calls, total_s, mean_s, min_s, max_s}), mirroring the sorted
    summary of reference ``profiler.cc:476``. Clears the recorded events
    AND spans so the next profiling window starts empty."""
    global _enabled
    _enabled = False
    table = {}
    for name, times in _events.items():
        table[name] = {
            "calls": len(times),
            "total_s": sum(times),
            "mean_s": sum(times) / len(times),
            "min_s": min(times),
            "max_s": max(times),
        }
    reset_profiler()
    return table


def summary_string(table: Optional[dict] = None) -> str:
    table = table if table is not None else disable_profiler()
    rows = sorted(table.items(), key=lambda kv: -kv[1]["total_s"])
    lines = [f"{'Event':40s} {'Calls':>8s} {'Total(s)':>10s} {'Mean(ms)':>10s}"]
    for name, s in rows:
        lines.append(f"{name:40s} {s['calls']:8d} {s['total_s']:10.4f} {s['mean_s'] * 1e3:10.3f}")
    return "\n".join(lines)


def export_chrome_trace(path: str) -> str:
    """Write recorded host spans as a Chrome Trace Event Format file,
    loadable in chrome://tracing / Perfetto UI. Device kernel timelines
    come from the ``torch.profiler`` trace of :func:`profiler`; this file
    carries the correlated host-side step phases."""
    tids: Dict[int, int] = {}
    events = []
    for name, start_us, dur_us, tid in _spans:
        tids.setdefault(tid, len(tids))
        events.append({
            "name": name, "ph": "X", "cat": "host",
            "ts": start_us, "dur": dur_us,
            "pid": os.getpid(), "tid": tids[tid],
        })
    for tid, idx in tids.items():  # ph:"M" so Perfetto labels host threads
        events.append({
            "name": "thread_name", "ph": "M", "pid": os.getpid(), "tid": idx,
            "args": {"name": _thread_names.get(tid, f"thread-{idx}")},
        })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"producer": "paddle_tpu_torch.core.profiler"},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.rename(tmp, path)
    return path


def step_breakdown(table: Optional[dict] = None) -> Dict[str, float]:
    """Mean seconds per phase for the canonical step phases, for a
    benchmark's per-step breakdown table (reference ``fluid_benchmark.py``
    profile output)."""
    table = table if table is not None else {
        name: {"mean_s": sum(ts) / len(ts)} for name, ts in _events.items() if ts
    }
    return {name: s["mean_s"] for name, s in table.items()}


# the torch.profiler session of start_profiler()/profiler(): (profile, dir)
_session: Optional[tuple] = None


def _log_dir(log_dir: Optional[str]) -> str:
    from paddle_tpu_torch.core import config

    return (log_dir or config.flags().profile_dir
            or os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile"))


def start_profiler(log_dir: Optional[str] = None) -> None:
    """Start host spans and a ``torch.profiler`` trace (CPU activity, and
    CUDA when a card is present) that :func:`stop_profiler` writes into
    ``log_dir``."""
    global _session
    if _session is not None:
        raise RuntimeError("a profiler session is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    enable_profiler()
    prof.__enter__()
    _session = (prof, _log_dir(log_dir))


def stop_profiler() -> Dict[str, Dict[str, float]]:
    """Stop the session of :func:`start_profiler`: the device trace goes
    to ``<log_dir>/trace.chrome.json``, the host spans to
    ``<log_dir>/timeline.chrome.json``; returns the host aggregation
    table."""
    global _session
    if _session is None:
        raise RuntimeError("no profiler session is running")
    prof, log_dir = _session
    _session = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.chrome.json"))
    export_chrome_trace(os.path.join(log_dir, "timeline.chrome.json"))
    return disable_profiler()


@contextlib.contextmanager
def profiler(log_dir: Optional[str] = None) -> Iterator[None]:
    """Device-trace context manager (fluid.profiler.profiler parity):
    captures a ``torch.profiler`` trace and the host spans into
    ``log_dir`` (``trace.chrome.json``, ``timeline.chrome.json``)."""
    start_profiler(log_dir)
    try:
        yield
    finally:
        table = stop_profiler()
    from paddle_tpu_torch.core import logging as ptlog

    ptlog.info("profiler trace written to %s\n%s", _log_dir(log_dir),
               summary_string(table))


def reset_profiler() -> None:
    """Clear recorded host events AND timeline spans (reference
    ``profiler.py:104``)."""
    _events.clear()
    _spans.clear()
    _thread_names.clear()


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Reference ``profiler.py:39``: the CUDA runtime profiler
    (``cudaProfilerStart``/``cudaProfilerStop`` through
    ``torch.cuda.profiler``) runs around the block, for an external
    profiler attached to the process to capture; ``output_mode`` and
    ``config`` were nvprof's and are accepted for the signature. Without a
    card there is no CUDA runtime: as the JAX package does, it warns and
    delegates to :func:`profiler` with ``log_dir=output_file``."""
    if not torch.cuda.is_available():
        import warnings

        warnings.warn("cuda_profiler: no CUDA runtime; delegating to the torch.profiler "
                      "trace (see paddle_tpu_torch.core.profiler.profiler)", stacklevel=3)
        with profiler(log_dir=output_file):
            yield
        return
    torch.cuda.profiler.start()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.profiler.stop()
