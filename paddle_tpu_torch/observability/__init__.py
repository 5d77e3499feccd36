"""Observability — the structured run log (:mod:`.runlog`) and the typed
metric registry (:mod:`.metrics`). The rest of the JAX package's
observability stack (exporter, MFU, goodput, roofline, fleet rollup) waits
for its own slice (``ROADMAP.md``)."""

from paddle_tpu_torch.observability import metrics, runlog  # noqa: F401
