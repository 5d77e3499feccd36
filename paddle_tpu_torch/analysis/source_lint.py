"""Repo source lint: AST checks for paddle_tpu_torch's own invariants —
port of ``paddle_tpu/analysis/source_lint.py``.

Generic linters cannot know the package's rules; this one encodes them:

* ``traced-wallclock`` / ``traced-py-rng`` — model and op code (the
  ``ops``/``layers``/``models`` trees and ``nets.py``) must not call
  wall-clock functions or Python/global-numpy RNGs. That code is what
  ``torch.export`` (``io.save_inference_model``) traces: a clock read
  there is frozen into the exported program at trace time and replayed
  forever after. And the port draws every random number from an explicit
  ``torch.Generator`` (``framework.next_rng``, the apply's ``rng``): a draw
  from a hidden global stream breaks the seeded equality with the JAX
  package and makes a run unrepeatable. ``ops/cuda/build.py`` (the
  ``nvcc`` builder, which times its builds) runs before any trace and is
  not model code;
* ``bare-assert`` — user-facing (public) functions must raise
  ``paddle_tpu_torch.core.enforce.enforce()`` instead of ``assert``:
  asserts vanish under ``python -O`` and carry no structured context;
* ``metric-name`` — metric names at ``inc_counter``/``set_gauge``/
  ``observe`` call sites must be dotted ``subsystem.snake_case``
  (``trainer.steps_total``): the exporter groups families by subsystem
  prefix and a flat or CamelCase name lands outside every dashboard query;
* ``span-name`` — span/event names at ``record_event``/``start_span``/
  ``start_trace``/``record_span`` call sites follow the same dotted
  lowercase convention (``serving.execute``): the merged Chrome-trace
  export and ``phase_totals`` group timeline rows by that prefix;
* ``fleet-metric-kind`` — ``serving.fleet.*`` families are recomputed on
  every ``FleetView.rollup()`` and must be published with ``set_gauge``:
  an ``inc_counter``/``observe`` there accumulates across rollup calls and
  double-counts the fleet.

Not applicable here: ``compat-import`` (``shard_map`` moved between jax
releases; the port imports no jax) and ``unguarded-export-import``
(``jax.export`` is absent on older jax; ``torch.export`` is part of every
PyTorch the port supports).

Runnable as ``python -m paddle_tpu_torch.analysis`` and over the whole
tree in ``tests/test_torch_source_lint.py``. Suppress a finding with a
``# lint: allow`` comment on the offending line.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Sequence

from paddle_tpu_torch.analysis.diagnostics import ERROR, Diagnostic

__all__ = ["lint_source", "lint_file", "default_roots"]

_SUPPRESS = "# lint: allow"
_PACKAGE = "paddle_tpu_torch"

# dirs (relative to the package) of model and op code (what torch.export traces)
_TRACED_DIRS = ("ops", "layers", "models")
_TRACED_FILES = ("nets.py",)
# files under those dirs that never run inside a trace
_UNTRACED = (("ops", "cuda", "build.py"),)

# dotted call chains that freeze a trace-time value into the program
_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow", "datetime.date.today",
}
# np.random.<fn> constructors that are fine (explicitly seeded generators
# passed around as values, not hidden global state)
_NP_RANDOM_OK = {"RandomState", "default_rng", "Generator", "SeedSequence",
                 "PCG64", "Philox", "MT19937", "BitGenerator"}

# metric-registry entry points whose first argument is a metric name
_METRIC_FNS = ("inc_counter", "set_gauge", "observe")
# dotted subsystem.snake_case with at least one dot: "trainer.steps_total"
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
# an f-string name must open with a literal "subsystem." prefix whose head
# stays inside the legal alphabet (variable parts belong in labels=)
_METRIC_PREFIX_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z0-9_.]*$")

# span/event entry points whose first argument is a timeline name
_SPAN_FNS = ("record_event", "start_span", "start_trace", "record_span")

# fleet rollup families are recomputed every FleetView.rollup(): only
# set_gauge may publish them
_FLEET_PREFIX = "serving.fleet."
_FLEET_GAUGE_ONLY_FNS = ("inc_counter", "observe")


def default_roots() -> List[str]:
    """The package tree this lint governs."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def python_files(paths: Optional[Sequence[str]]) -> List[str]:
    """The ``.py`` files of ``paths`` (files, or directories walked in
    order; default: the package)."""
    targets: List[str] = []
    for p in (list(paths) if paths else default_roots()):
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                targets.extend(os.path.join(dirpath, f)
                               for f in sorted(filenames) if f.endswith(".py"))
        else:
            targets.append(p)
    return targets


def read_source(path: str, text: Optional[str]):
    """``(tree, lines)`` of a file, or ``(None, [syntax-error diagnostic])``."""
    if text is None:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    try:
        return ast.parse(text, filename=path), text.splitlines()
    except SyntaxError as e:
        return None, [Diagnostic("syntax-error", str(e), where=f"{path}:{e.lineno or 0}")]


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Reporter(ast.NodeVisitor):
    """A visitor that records :class:`Diagnostic` s against the lines of
    one file, dropping those on a ``# lint: allow`` line."""

    def __init__(self, path: str, source_lines: List[str]):
        self.path = path
        self.lines = source_lines
        self.diags: List[Diagnostic] = []

    def _diag(self, code: str, message: str, node: ast.AST, severity: str = ERROR) -> None:
        line_no = getattr(node, "lineno", 0)
        src = self.lines[line_no - 1] if 0 < line_no <= len(self.lines) else ""
        if _SUPPRESS in src:
            return
        self.diags.append(Diagnostic(code, message, severity=severity,
                                     where=f"{self.path}:{line_no}", source=src))


def _rel_parts(path: str) -> List[str]:
    norm = os.path.normpath(path).split(os.sep)
    if _PACKAGE in norm:
        return norm[len(norm) - 1 - norm[::-1].index(_PACKAGE) + 1:]
    return norm[-2:]


def _is_traced_path(path: str) -> bool:
    rel = _rel_parts(path)
    if tuple(rel) in _UNTRACED:
        return False
    if rel and rel[0] in _TRACED_DIRS:
        return True
    return bool(rel) and rel[-1] in _TRACED_FILES


class _Linter(Reporter):
    def __init__(self, path: str, source_lines: List[str], traced: bool):
        super().__init__(path, source_lines)
        self.traced = traced
        self._scope: List[str] = []  # enclosing class/function names

    def _public_context(self) -> bool:
        """True when every enclosing def/class is public (dunders count as
        public: __init__/__call__ are user entry points; a single leading
        underscore marks internal)."""
        return all(not name.startswith("_") or (name.startswith("__") and name.endswith("__"))
                   for name in self._scope)

    def _visit_scoped(self, node) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_scoped
    visit_AsyncFunctionDef = _visit_scoped
    visit_ClassDef = _visit_scoped

    def visit_Call(self, node: ast.Call) -> None:
        if self.traced:
            self._check_traced_call(node)
        self._check_name(node, _METRIC_FNS, "metric-name", "metric",
                         "'trainer.steps_total'); un-prefixed names land outside every "
                         "dashboard query", "prefer a fixed name plus labels= for the "
                         "variable part")
        self._check_name(node, _SPAN_FNS, "span-name", "span",
                         "'serving.execute'); free-form names fragment the merged trace "
                         "timeline and phase_totals() grouping", "put the variable part "
                         "in span attributes, not the name")
        self.generic_visit(node)

    def _check_traced_call(self, node: ast.Call) -> None:
        chain = dotted(node.func)
        if chain in _WALLCLOCK_CALLS:
            self._diag("traced-wallclock",
                       f"{chain}() inside model/op code is frozen into a torch.export "
                       "program at trace time and replayed on every later call; thread "
                       "times in as inputs instead", node)
        elif chain and chain.startswith("random."):
            self._diag("traced-py-rng",
                       f"{chain}() uses Python's global RNG inside model/op code; draw "
                       "from the apply's torch.Generator (framework.next_rng)", node)
        elif chain and chain.startswith(("np.random.", "numpy.random.")) \
                and chain.rsplit(".", 1)[-1] not in _NP_RANDOM_OK:
            self._diag("traced-py-rng",
                       f"{chain}() draws from numpy's hidden global RNG inside model/op "
                       "code; pass an explicit np.random.RandomState or torch.Generator "
                       "instead", node)

    def _check_name(self, node: ast.Call, fns: Iterable[str], code: str, kind: str,
                    example: str, fstring_hint: str) -> None:
        """``code``: a literal first argument of a ``fns`` call must be dotted
        lowercase; an f-string must open with a literal ``subsystem.``
        prefix. Non-literal names are out of scope."""
        chain = dotted(node.func)
        fn = chain.rsplit(".", 1)[-1] if chain else ""
        if fn not in fns or not node.args:
            return
        arg0 = node.args[0]
        if isinstance(arg0, ast.Constant) and isinstance(arg0.value, str):
            if not _METRIC_NAME_RE.match(arg0.value):
                what = "dotted subsystem.snake_case" if kind == "metric" else "dotted lowercase"
                self._diag(code, f"{kind} name {arg0.value!r} is not {what} (e.g. {example}",
                           node)
            elif (kind == "metric" and arg0.value.startswith(_FLEET_PREFIX)
                  and fn in _FLEET_GAUGE_ONLY_FNS):
                self._diag("fleet-metric-kind",
                           f"{arg0.value!r} is a fleet rollup family: it is recomputed on "
                           "every FleetView.rollup(), so it must be published with "
                           "set_gauge — a counter/histogram here double-counts the fleet "
                           "on every rollup call", node)
        elif isinstance(arg0, ast.JoinedStr):
            head = arg0.values[0] if arg0.values else None
            if not (isinstance(head, ast.Constant) and isinstance(head.value, str)
                    and _METRIC_PREFIX_RE.match(head.value)):
                self._diag(code, f"f-string {kind} name must start with a literal "
                                 f"'subsystem.' prefix ({fstring_hint})", node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._public_context():
            self._diag("bare-assert",
                       "bare assert on a user-facing path: it vanishes under python -O "
                       "and reports no context — use "
                       "paddle_tpu_torch.core.enforce.enforce()", node)
        self.generic_visit(node)


def lint_file(path: str, text: Optional[str] = None,
              traced: Optional[bool] = None) -> List[Diagnostic]:
    """Lint one Python file. ``traced`` overrides the path-based detection
    of model/op code (tests use this on fixture files)."""
    tree, lines = read_source(path, text)
    if tree is None:
        return lines
    linter = _Linter(path, lines, _is_traced_path(path) if traced is None else traced)
    linter.visit(tree)
    return linter.diags


def lint_source(paths: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Lint a set of files/directories (default: the paddle_tpu_torch package)."""
    return [d for path in python_files(paths) for d in lint_file(path)]
