"""paddle_tpu_torch.tracing — end-to-end request/step tracing (a port of
``paddle_tpu.tracing``).

Causally-linked spans with W3C-traceparent-style propagated IDs across the
whole stack (serving queue → batcher → dispatch → device execution → reply;
trainer data-wait → h2d → compile → step → checkpoint), per-device memory
telemetry, straggler detection, the per-request token-latency waterfall,
and a merged Chrome/Perfetto trace export.

Importing this package registers a runlog context provider: every runlog
event emitted inside an active span automatically gains ``trace_id``/
``span_id`` fields, so fault/rollback/straggler lines correlate with the
span tree without call-site changes.
"""

from __future__ import annotations

from paddle_tpu_torch.tracing import export, memory, straggler, waterfall  # noqa: F401
from paddle_tpu_torch.tracing.context import (  # noqa: F401
    Span,
    SpanContext,
    active_spans,
    current_context,
    disable_tracing,
    enable_tracing,
    epoch_s_to_pc_us,
    pc_us_to_epoch_s,
    phase_totals,
    record_span,
    reset_tracing,
    spans,
    spans_for_trace,
    start_span,
    start_trace,
    tracing_enabled,
    validate_trace,
)
from paddle_tpu_torch.tracing.export import (  # noqa: F401
    chrome_trace_doc,
    export_chrome_trace,
    validate_chrome_trace,
)
from paddle_tpu_torch.tracing.memory import (  # noqa: F401
    device_label,
    memory_history,
    record_executable_memory,
    reset_memory_telemetry,
    sample_device_memory,
)
from paddle_tpu_torch.tracing.straggler import StragglerDetector  # noqa: F401

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
    "chrome_trace_doc",
    "export_chrome_trace",
    "validate_chrome_trace",
    "sample_device_memory",
    "memory_history",
    "reset_memory_telemetry",
    "record_executable_memory",
    "device_label",
    "StragglerDetector",
    "export",
    "memory",
    "straggler",
    "waterfall",
]


def _runlog_trace_context():
    ctx = current_context()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


def _install_runlog_provider() -> None:
    from paddle_tpu_torch.observability import metrics as _metrics
    from paddle_tpu_torch.observability import runlog as _runlog

    _runlog.set_context_provider(_runlog_trace_context)
    _metrics.declare_tracing_families()


_install_runlog_provider()
