"""Analysis — the shared :class:`~.diagnostics.Diagnostic` record, which
``core.locks.order_violations`` reports through. The JAX package's
analyzers (IR verifier, model and source lints) are not ported yet
(``ROADMAP.md``)."""

from paddle_tpu_torch.analysis.diagnostics import Diagnostic  # noqa: F401
