"""Merged Chrome/Perfetto trace export (a copy of
``paddle_tpu.tracing.export``).

The reference's ``DeviceTracer::GenProfile`` folded host annotations and
CUPTI kernel records into one timeline protobuf that ``tools/timeline.py``
converted for chrome://tracing. Here the merge happens directly into Chrome
Trace Event Format JSON, combining four sources on one timebase
(``time.perf_counter()`` microseconds):

* tracing spans (``ph:"X"``, with trace_id/span_id/parent_id in ``args``)
* host profiler spans from ``core.profiler`` (``ph:"X"``, cat ``host``)
* runlog events (``ph:"i"`` instants; epoch timestamps converted via the
  import-time clock offset)
* device HBM samples (``ph:"C"`` counter tracks per device)
* roofline achieved-rate samples from the kernel cost ledger
  (``ph:"C"`` counter tracks ``roofline.achieved_gflops_per_s`` /
  ``roofline.achieved_gbytes_per_s``, one series per kernel)

``validate_chrome_trace`` is the strict schema parser the smoke gate and
tests run over the artifact — same posture as
``observability.exporter.parse_text_exposition``: unknown phases, missing
required keys, or non-numeric timestamps fail loudly rather than rendering
as an empty timeline.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.tracing import context as _ctx
from paddle_tpu_torch.tracing import memory as _mem

__all__ = ["chrome_trace_doc", "export_chrome_trace", "validate_chrome_trace"]

# Stable synthetic tids for the non-thread tracks. Host thread tracks are
# numbered from _FIRST_THREAD_TID up; the roofline track draws from that
# range through the same tid allocator (keyed by a sentinel raw tid that
# no real thread id can collide with).
_RUNLOG_TID = 0
_DEVICE_TID = 1
_FIRST_THREAD_TID = 2
_ROOFLINE_RAW_TID = -1


def chrome_trace_doc(
    runlog_path: Optional[str] = None,
    include_profiler: bool = True,
    include_device: bool = True,
    include_roofline: bool = True,
) -> dict:
    """Build the merged trace document. ``runlog_path`` defaults to the
    installed runlog's file (if any)."""
    pid = os.getpid()
    events: List[dict] = []
    tid_map: Dict[int, int] = {}
    thread_names: Dict[int, str] = {}

    def chrome_tid(raw_tid: int, name: str) -> int:
        if raw_tid not in tid_map:
            tid_map[raw_tid] = _FIRST_THREAD_TID + len(tid_map)
            thread_names[tid_map[raw_tid]] = name
        return tid_map[raw_tid]

    for span in _ctx.spans():
        if span.t1_us is None:
            continue
        args = {
            "trace_id": span.context.trace_id,
            "span_id": span.context.span_id,
            "parent_id": span.context.parent_id,
        }
        for k, v in span.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
        events.append({
            "name": span.name, "ph": "X", "cat": "tracing",
            "ts": span.t0_us, "dur": max(0.0, span.t1_us - span.t0_us),
            "pid": pid, "tid": chrome_tid(span.tid, span.thread_name),
            "args": args,
        })

    if include_profiler:
        prof_threads = prof.thread_names()
        for name, start_us, dur_us, raw_tid in prof.spans():
            events.append({
                "name": name, "ph": "X", "cat": "host",
                "ts": start_us, "dur": dur_us,
                "pid": pid,
                "tid": chrome_tid(raw_tid, prof_threads.get(raw_tid, f"thread-{raw_tid}")),
            })

    if runlog_path is None:
        from paddle_tpu_torch.observability import runlog as _runlog

        log = _runlog.get_runlog()
        runlog_path = log.path if log is not None else None
    if runlog_path and os.path.exists(runlog_path):
        from paddle_tpu_torch.observability import runlog as _runlog

        for ev in _runlog.read_runlog(runlog_path):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            events.append({
                "name": str(ev.get("kind", "event")), "ph": "i", "cat": "runlog",
                "ts": _ctx.epoch_s_to_pc_us(float(ts)), "s": "p",
                "pid": pid, "tid": _RUNLOG_TID,
                "args": {k: v for k, v in ev.items() if k != "ts"},
            })

    if include_device:
        for t_us, dev_label, in_use in _mem.memory_history():
            events.append({
                "name": "device.hbm.bytes_in_use", "ph": "C", "cat": "device",
                "ts": t_us, "pid": pid, "tid": _DEVICE_TID,
                "args": {dev_label: in_use},
            })

    if include_roofline:
        from paddle_tpu_torch.observability import roofline as _roofline

        samples = _roofline.history()
        if samples:
            tid = chrome_tid(_ROOFLINE_RAW_TID, "roofline")
            for t_us, kernel, flops_per_s, bytes_per_s in samples:
                events.append({
                    "name": "roofline.achieved_gflops_per_s", "ph": "C",
                    "cat": "roofline", "ts": t_us, "pid": pid, "tid": tid,
                    "args": {kernel: flops_per_s / 1e9},
                })
                events.append({
                    "name": "roofline.achieved_gbytes_per_s", "ph": "C",
                    "cat": "roofline", "ts": t_us, "pid": pid, "tid": tid,
                    "args": {kernel: bytes_per_s / 1e9},
                })

    meta_tracks = dict(thread_names)
    meta_tracks[_RUNLOG_TID] = "runlog"
    meta_tracks[_DEVICE_TID] = "device.hbm"
    for tid, name in sorted(meta_tracks.items()):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"producer": "paddle_tpu_torch.tracing"},
    }


def export_chrome_trace(
    path: str,
    runlog_path: Optional[str] = None,
    include_profiler: bool = True,
    include_device: bool = True,
    include_roofline: bool = True,
) -> str:
    """Write the merged trace atomically (tmp + rename, same contract as
    ``profiler.export_chrome_trace``) and return ``path``."""
    doc = chrome_trace_doc(
        runlog_path=runlog_path,
        include_profiler=include_profiler,
        include_device=include_device,
        include_roofline=include_roofline,
    )
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.rename(tmp, path)
    return path


_KNOWN_PHASES = ("X", "i", "C", "M")


def validate_chrome_trace(doc) -> Dict[str, int]:
    """Strictly validate a Chrome Trace Event Format document. Returns
    per-phase event counts on success; raises ``ValueError`` listing every
    violation otherwise. Accepts a dict (JSON-object form) or a JSON
    string."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError("chrome trace: document must be an object with a "
                         "'traceEvents' array")
    counts: Dict[str, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: event is not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        counts[ph] = counts.get(ph, 0) + 1
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty 'name'")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"{where}: 'pid' must be an int")
        if not isinstance(ev.get("tid"), int):
            problems.append(f"{where}: 'tid' must be an int")
        if ph in ("X", "i", "C"):
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"{where}: '{ph}' event needs numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: 'X' event needs numeric 'dur' >= 0")
        if ph == "i":
            if ev.get("s") not in ("g", "p", "t"):
                problems.append(f"{where}: 'i' event needs scope 's' in g/p/t")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                problems.append(
                    f"{where}: 'C' event needs non-empty numeric 'args'")
        if ph == "M":
            args = ev.get("args")
            if not isinstance(args, dict) or not isinstance(args.get("name"), str):
                problems.append(f"{where}: 'M' event needs args.name")
    if problems:
        raise ValueError(
            "invalid chrome trace (%d problem%s):\n  %s" % (
                len(problems), "s" if len(problems) != 1 else "",
                "\n  ".join(problems[:50]),
            )
        )
    return counts
