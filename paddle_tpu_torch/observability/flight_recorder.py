"""Post-mortem flight recorder: the last N seconds of an engine, on disk.

A copy of ``paddle_tpu.observability.flight_recorder``. When an engine
dies — breaker trip after repeated step faults, an injected ``kill()``, a
step fault on the card — the evidence is in process memory: the span ring, the runlog tail, which
instrumented locks were held, which KV pages were still referenced. By
the time someone attaches, the process is gone. A :class:`FlightRecorder`
keeps nothing extra at steady state (spans and runlog already ring); on a
trip it snapshots the tails plus the engine's crash-state — held locks,
``PageAllocator.refcounts()``, host-tier and breaker state, the full
metrics snapshot, and the roofline cost-ledger snapshot (which kernels
were compute/memory/overhead-bound when it died) — into one JSON bundle,
written atomically (tmp +
``os.replace``) so a half-written bundle can never be mistaken for a
post-mortem. Retention is bounded: only the newest ``keep`` bundles
survive, so a crash-looping engine cannot fill the disk.

Engines call :func:`maybe_dump` at their fault points; it is a no-op
until a recorder is :func:`install`\\ ed and never raises — a recorder
failure must not take down the engine it is recording.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import runlog

__all__ = [
    "FlightRecorder",
    "install",
    "uninstall",
    "installed",
    "maybe_dump",
]

_lock = locks.Lock("observability.flight_recorder")
_recorder: Optional["FlightRecorder"] = None


def install(recorder: "FlightRecorder") -> "FlightRecorder":
    """Make ``recorder`` the process recorder (replacing any previous)."""
    global _recorder
    with _lock:
        _recorder = recorder
    return recorder


def uninstall() -> None:
    global _recorder
    with _lock:
        _recorder = None


def installed() -> Optional["FlightRecorder"]:
    with _lock:
        return _recorder


def maybe_dump(reason: str, engine: Any = None) -> Optional[str]:
    """Dump a bundle if a recorder is installed; else no-op.

    This is the engine-side hook: it must never raise (the caller is a
    fault path) and returns the bundle path or ``None``."""
    rec = installed()
    if rec is None:
        return None
    try:
        return rec.dump(reason, engine=engine)
    except Exception as e:  # recorder bugs must not cascade into the fault
        ptlog.warning("flight recorder dump failed: %r", e)
        return None


def _span_dict(s: Any) -> Dict[str, Any]:
    return {
        "name": s.name,
        "trace_id": s.context.trace_id,
        "span_id": s.context.span_id,
        "parent_id": s.context.parent_id,
        "t0_us": s.t0_us,
        "t1_us": s.t1_us,
        "attrs": dict(s.attrs),
    }


class FlightRecorder:
    """Bounded post-mortem bundle writer.

    ``out_dir`` receives ``flightrec_<seq>_<reason>.json`` bundles;
    ``span_tail``/``runlog_tail``/``alert_tail`` bound how much history a
    bundle carries, and ``keep`` bounds how many bundles survive (oldest
    pruned first). All knobs trade disk for hindsight; the defaults hold
    a bundle under ~1 MB."""

    def __init__(self, out_dir: str, span_tail: int = 256,
                 runlog_tail: int = 256, alert_tail: int = 64,
                 keep: int = 8):
        enforce(keep >= 1, f"FlightRecorder keep must be >= 1, got {keep}")
        enforce(span_tail >= 0 and runlog_tail >= 0 and alert_tail >= 0,
                "FlightRecorder tail sizes must be >= 0")
        self.out_dir = out_dir
        self.span_tail = span_tail
        self.runlog_tail = runlog_tail
        self.alert_tail = alert_tail
        self.keep = keep
        self._seq = 0
        self._mu = locks.Lock("observability.flight_recorder.dump")
        os.makedirs(out_dir, exist_ok=True)

    # -- tail collectors (each tolerant: a bundle with a hole beats none) ----

    def _spans(self) -> List[Dict[str, Any]]:
        from paddle_tpu_torch import tracing  # lazy: tracing imports observability

        try:
            return [_span_dict(s) for s in tracing.spans()[-self.span_tail:]]
        except Exception:
            return []

    def _runlog(self) -> List[Dict[str, Any]]:
        log = runlog.get_runlog()
        if log is None:
            return []
        try:
            return runlog.read_runlog(log.path)[-self.runlog_tail:]
        except (OSError, ValueError):
            return []  # torn tail mid-crash: the rest still stands

    def _alerts(self) -> List[Dict[str, Any]]:
        try:
            from paddle_tpu_torch.watch import alerts as _alerts

            hub = _alerts.default_hub()
            return [a.as_dict() for a in hub.alerts(self.alert_tail or None)]
        except Exception:
            return []

    @staticmethod
    def _locks() -> Dict[str, Any]:
        try:
            return {"enabled": locks.enabled(),
                    "held": locks.held_snapshot()}
        except Exception:
            return {"enabled": False, "held": []}

    @staticmethod
    def _roofline() -> Dict[str, Any]:
        try:
            from paddle_tpu_torch.observability import roofline as _roofline

            return {"summary": _roofline.summary(),
                    "entries": _roofline.snapshot()}
        except Exception:
            return {"summary": {}, "entries": []}

    @staticmethod
    def _engine_state(engine: Any) -> Dict[str, Any]:
        if engine is None:
            return {}
        state: Dict[str, Any] = {}
        try:
            state["engine"] = engine.metrics.engine_label
            state["metrics"] = engine.metrics.snapshot()
        except Exception:
            pass
        try:
            state["breaker"] = engine.breaker.snapshot()
        except Exception:
            pass
        try:
            state["kv_refcounts"] = engine.kv.allocator.refcounts()
        except Exception:
            pass
        try:
            tier = getattr(engine, "host_tier", None)
            if tier is not None:
                state["host_tier"] = tier.stats()
        except Exception:
            pass
        return state

    # -- bundle write --------------------------------------------------------

    def dump(self, reason: str, engine: Any = None) -> str:
        """Write one bundle and return its path. Atomic: readers only ever
        see complete bundles. Prunes to the newest ``keep`` afterwards."""
        enforce(bool(reason), "flight recorder dump needs a reason")
        with self._mu:
            self._seq += 1
            seq = self._seq
            bundle = {
                "format": "paddle_tpu_torch.flightrec.v1",
                "reason": reason,
                "ts_unix": time.time(),
                "seq": seq,
                "pid": os.getpid(),
                "spans": self._spans(),
                "runlog": self._runlog(),
                "alerts": self._alerts(),
                "locks": self._locks(),
                "roofline": self._roofline(),
                **self._engine_state(engine),
            }
            name = f"flightrec_{seq:06d}_{reason}.json"
            path = os.path.join(self.out_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
            self._prune()
        prof.inc_counter("flight_recorder.bundles_total",
                         labels={"reason": reason})
        ptlog.info("flight recorder: wrote %s (%s)", path, reason)
        return path

    def bundles(self) -> List[str]:
        """Paths of surviving bundles, oldest first."""
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if n.startswith("flightrec_")
                           and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.out_dir, n) for n in names]

    def _prune(self) -> None:
        paths = self.bundles()
        for path in paths[:-self.keep]:
            try:
                os.remove(path)
                prof.inc_counter("flight_recorder.pruned_total")
            except OSError:
                pass
