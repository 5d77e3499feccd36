"""paddle_tpu_torch.analysis — static analysis of models and of the
package's own sources, one diagnostics vocabulary (:mod:`.diagnostics`,
which ``core.locks.order_violations`` also reports through):

* :mod:`.model_lint` — traces a ``framework.Model`` on the ``meta``
  device (the JAX package's ``jax.eval_shape``) and reports structural
  problems; ``ServingEngine`` runs it before warm-up;
* :mod:`.source_lint` — AST lint of the package's sources for its own
  invariants (metric and span names, bare asserts, clocks and global RNGs
  in model/op code);
* :mod:`.concurrency_lint` — AST lint for the locking discipline that
  ``core.locks`` enforces at run time (raw primitives, unbounded waits,
  callbacks/blocking I/O under a lock);
* :mod:`.retrace_lint` — AST lint for the compile-once discipline of
  ``torch.export``/``torch.compile``/CUDA-graph capture (trace-frozen
  config reads, dynamic-closure ``len()``, a compile in a loop);
* :mod:`.shard_analysis` — zero-FLOP sharding-layout analyzer of a
  ``GroupLayout`` over a ``meta`` init's parameter shapes.

All load lazily, as in the JAX package: they import ``parallel/``,
``framework`` or ``core.locks``, and ``core.locks`` imports this package.
The JAX package's IR verifier (``VerificationError``, ``verify_or_raise``,
``verify_program``, ``verify_text``) checks the native program, which is
not ported yet (``ROADMAP.md`` §A item 8).

CLI: ``python -m paddle_tpu_torch.analysis [paths...] [--only PASS]`` —
one exit code over all passes.
"""

from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ERROR,
    WARNING,
    Diagnostic,
    format_diagnostics,
    has_errors,
)

__all__ = [
    "Diagnostic",
    "ERROR",
    "WARNING",
    "analyze_layout",
    "analyze_model",
    "compare_layouts",
    "format_diagnostics",
    "has_errors",
    "lint_concurrency",
    "lint_file",
    "lint_group_layout_or_raise",
    "lint_model",
    "lint_retrace",
    "lint_source",
    "tp_comm_report",
]

_LAZY = {
    "lint_model": "paddle_tpu_torch.analysis.model_lint",
    "lint_source": "paddle_tpu_torch.analysis.source_lint",
    "lint_file": "paddle_tpu_torch.analysis.source_lint",
    "lint_concurrency": "paddle_tpu_torch.analysis.concurrency_lint",
    "lint_retrace": "paddle_tpu_torch.analysis.retrace_lint",
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
