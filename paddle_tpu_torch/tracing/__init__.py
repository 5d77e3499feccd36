"""Tracing — the per-request token-latency waterfall (:mod:`.waterfall`).
The rest of the JAX package's tracing (spans, W3C trace context, the
straggler and memory watches) waits for the telemetry slice
(``ROADMAP.md``)."""

from paddle_tpu_torch.tracing import waterfall  # noqa: F401
