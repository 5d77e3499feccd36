"""Shared diagnostic record — a copy of ``paddle_tpu.analysis.diagnostics``.

Findings are first-class values instead of exception strings, so callers
(tests, ``core.locks.order_violations``) can filter by severity/code and
print uniformly. The reference framework's analogue is the
enforce-message convention of ``PADDLE_ENFORCE``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

__all__ = ["Diagnostic", "format_diagnostics", "has_errors", "ERROR", "WARNING"]

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Diagnostic:
    """One finding.

    ``code`` is a stable kebab-case identifier (tests match on it),
    ``where`` locates the finding (``program.txt:12``, ``file.py:34``, a
    parameter name), and ``source`` carries the offending line when there
    is one.
    """

    code: str
    message: str
    severity: str = ERROR
    where: str = ""
    source: str = ""

    def __str__(self) -> str:
        loc = f"{self.where}: " if self.where else ""
        src = f"\n    | {self.source.strip()}" if self.source else ""
        return f"{loc}{self.severity}[{self.code}] {self.message}{src}"


def has_errors(diags: Iterable[Diagnostic]) -> bool:
    return any(d.severity == ERROR for d in diags)


def format_diagnostics(diags: Iterable[Diagnostic], limit: Optional[int] = None) -> str:
    diags = list(diags)
    shown: List[str] = [str(d) for d in (diags[:limit] if limit else diags)]
    if limit and len(diags) > limit:
        shown.append(f"... and {len(diags) - limit} more")
    return "\n".join(shown)
