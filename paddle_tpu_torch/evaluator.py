"""Evaluator shims, port of ``paddle_tpu/evaluator.py`` (reference
``python/paddle/fluid/evaluator.py``).

The reference module was already deprecated in favor of ``fluid.metrics``;
the stateful accumulators live in :mod:`paddle_tpu_torch.metrics`, and this
module re-exports them under the Evaluator names so reference code ports
cleanly. Accumulation is host-side numpy over fetched per-batch values.
"""

from __future__ import annotations

from paddle_tpu_torch.metrics import (  # noqa: F401
    Accuracy,
    ChunkEvaluator,
    DetectionMAP,
    EditDistance,
)

__all__ = ["Accuracy", "ChunkEvaluator", "DetectionMAP", "EditDistance"]
