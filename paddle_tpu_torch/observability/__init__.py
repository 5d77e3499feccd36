"""paddle_tpu_torch.observability — process-wide telemetry (a port of
``paddle_tpu.observability``).

Layered on the counter/gauge bridge in ``core.profiler``:

- :mod:`~paddle_tpu_torch.observability.metrics` — typed registry of
  labeled counters, gauges, and fixed/exponential-bucket histograms;
- :mod:`~paddle_tpu_torch.observability.runlog` — append-only JSONL
  run-event log (step / compile / checkpoint / resilience events);
- :mod:`~paddle_tpu_torch.observability.mfu` — MFU from the step's counted
  FLOPs (a ``TorchDispatchMode`` over ``torch.utils.flop_counter``'s
  formulas, plus the hand-written kernels' own reports) vs. the card's
  peak, plus goodput/badput accounting;
- :mod:`~paddle_tpu_torch.observability.roofline` — per-callable cost
  ledger (counted FLOPs/bytes + CUDA-event device time) with roofline
  verdicts (``compute_bound`` / ``memory_bound`` / ``overhead_bound``),
  served at the exporter's ``/roofline`` endpoint;
- :mod:`~paddle_tpu_torch.observability.exporter` — stdlib Prometheus
  ``/metrics`` + ``/healthz`` HTTP endpoint, plus debug endpoints
  (``/runlog/tail``, ``/trace``, ``/roofline``, ``/alerts``, ``/slo``,
  ``/tenants`` = ``/admission``, ``/locks``, ``/waterfall/<rid>``,
  ``/fleet``, ``/trace/<trace_id>``);
- :mod:`~paddle_tpu_torch.observability.flight_recorder` — post-mortem
  bundle writer: on a decode-engine fault, dumps span + runlog + alert
  tails, held locks, KV refcounts, and the breaker's state.

- :mod:`~paddle_tpu_torch.observability.fleet` — fleet rollups
  (``FleetView``: ``serving.fleet.*`` over a ``DecodeFleet`` or
  ``DisaggRouter``'s engines) served at ``/fleet``, and one request's
  cross-engine timeline (``trace_doc``) at ``/trace/<trace_id>``.

Cross-cutting: when :mod:`paddle_tpu_torch.tracing` is imported, every
runlog event emitted inside an active span carries ``trace_id``/``span_id``
fields, and ``device.hbm.*`` gauge families join the scrape.

Enable by flags (``PADDLE_TPU_METRICS_PORT=9100``,
``PADDLE_TPU_RUNLOG_PATH=run.jsonl``) or explicitly::

    from paddle_tpu_torch.observability import ObservabilityConfig, setup
    setup(ObservabilityConfig(metrics_port=0, runlog_path="run.jsonl"))

``Trainer`` calls :func:`setup` on construction (idempotent, no-op while
disabled), so setting the flags is enough.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.observability import (
    exporter,
    fleet,
    flight_recorder,
    metrics,
    mfu,
    roofline,
    runlog,
)
from paddle_tpu_torch.observability.exporter import MetricsServer, render_text
from paddle_tpu_torch.observability.fleet import FleetView
from paddle_tpu_torch.observability.flight_recorder import FlightRecorder
from paddle_tpu_torch.observability.metrics import (
    MetricRegistry,
    default_registry,
    exponential_buckets,
    linear_buckets,
)
from paddle_tpu_torch.observability.mfu import GoodputTracker
from paddle_tpu_torch.observability.runlog import RunLog, read_runlog

__all__ = [
    "ObservabilityConfig",
    "setup",
    "shutdown",
    "server",
    "metrics",
    "runlog",
    "mfu",
    "roofline",
    "exporter",
    "fleet",
    "flight_recorder",
    "FleetView",
    "FlightRecorder",
    "MetricRegistry",
    "MetricsServer",
    "GoodputTracker",
    "RunLog",
    "default_registry",
    "render_text",
    "read_runlog",
    "exponential_buckets",
    "linear_buckets",
]


@dataclasses.dataclass
class ObservabilityConfig:
    """What telemetry to turn on for this process.

    ``metrics_port``: < 0 disables the exporter, 0 binds an ephemeral port
    (read it back from ``server().port``), > 0 binds that port.
    ``runlog_path``: empty disables the run-event log.
    """

    metrics_port: int = -1
    metrics_host: str = "127.0.0.1"
    runlog_path: str = ""
    runlog_max_bytes: int = 0
    runlog_keep: int = 3

    @staticmethod
    def from_flags() -> "ObservabilityConfig":
        from paddle_tpu_torch.core import config

        f = config.flags()
        return ObservabilityConfig(
            metrics_port=f.metrics_port,
            metrics_host=f.metrics_host,
            runlog_path=f.runlog_path,
            runlog_max_bytes=f.runlog_max_bytes,
            runlog_keep=f.runlog_keep,
        )


_lock = locks.Lock("observability.install")
_server: Optional[MetricsServer] = None
_owned_runlog: Optional[RunLog] = None


def setup(config: Optional[ObservabilityConfig] = None) -> Optional[MetricsServer]:
    """Start the configured telemetry (idempotent; safe to call from every
    Trainer constructor). With no argument, reads
    ``ObservabilityConfig.from_flags()`` — all-default flags make this a
    no-op. Returns the running exporter, if any."""
    global _server, _owned_runlog
    config = config or ObservabilityConfig.from_flags()
    with _lock:
        if config.runlog_path and runlog.get_runlog() is None:
            _owned_runlog = RunLog(config.runlog_path,
                                   max_bytes=config.runlog_max_bytes,
                                   keep=config.runlog_keep)
            runlog.set_runlog(_owned_runlog)
        if config.metrics_port >= 0 and _server is None:
            _server = MetricsServer(
                host=config.metrics_host, port=config.metrics_port).start()
        return _server


def server() -> Optional[MetricsServer]:
    """The process-wide exporter started by :func:`setup`, if any."""
    return _server


def shutdown() -> None:
    """Stop the exporter and close the runlog that :func:`setup` opened."""
    global _server, _owned_runlog
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
        if _owned_runlog is not None:
            if runlog.get_runlog() is _owned_runlog:
                runlog.set_runlog(None)
            _owned_runlog.close()
            _owned_runlog = None
