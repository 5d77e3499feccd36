"""Analysis — the shared :class:`~.diagnostics.Diagnostic` record, which
``core.locks.order_violations`` reports through, and the shard-layout
analysis (:mod:`.shard_analysis`, loaded lazily as in the JAX package).
The JAX package's other analyzers (the IR verifier, the model, source,
concurrency and retrace lints) are not ported yet (``ROADMAP.md`` §A items
8 and 9)."""

from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ERROR,
    WARNING,
    Diagnostic,
    format_diagnostics,
    has_errors,
)

# loaded lazily: shard_analysis imports parallel/, which imports core.locks,
# which imports this package
_LAZY = {
    "analyze_layout": "paddle_tpu_torch.analysis.shard_analysis",
    "analyze_model": "paddle_tpu_torch.analysis.shard_analysis",
    "compare_layouts": "paddle_tpu_torch.analysis.shard_analysis",
    "lint_group_layout_or_raise": "paddle_tpu_torch.analysis.shard_analysis",
    "tp_comm_report": "paddle_tpu_torch.analysis.shard_analysis",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(mod), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
