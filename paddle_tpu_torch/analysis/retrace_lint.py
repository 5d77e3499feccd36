"""Retrace lint: AST checks for the compile-once discipline — port of
``paddle_tpu/analysis/retrace_lint.py``.

In the JAX package every hot program is a ``jax.jit``. The port runs
eagerly, and its compile-once points are where a function is traced
into a program that is then replayed: ``torch.export`` (the inference
program of ``io.save_inference_model``, the graph of ``debugger.py``),
``torch.compile``, ``torch.jit.trace``/``script``,
``torch.cuda.make_graphed_callables`` and capture under
``torch.cuda.graph``. A Python value read inside such a function is
frozen into the program at trace or capture time. Rules:

* ``retrace-config-read`` — ``config.flags()`` / ``os.getenv`` /
  ``os.environ[...]`` inside traced code: the read runs once, at trace
  time, and the exported or captured program bakes that value in forever
  (flipping the flag later silently does nothing);
* ``retrace-dynamic-len`` — ``len()`` of a closure/attribute capture
  inside traced code (``len()`` of a traced *argument* is shape-static and
  fine): the length freezes at trace time, and when the captured list
  grows the program is silently stale — or, guarded, retraces per size;
* ``retrace-jit-in-loop`` — a ``torch.compile`` / ``torch.export`` /
  ``torch.jit`` call lexically inside a ``for``/``while`` body: a fresh
  wrapper per iteration has an empty cache, so every iteration traces
  and compiles again.

Not applicable here: ``retrace-dict-order`` (``in_shardings`` /
``donate_argnums`` built in dict order: the port has no
``in_shardings``, ``out_shardings`` or ``donate_argnums``) and
``retrace-missing-static`` (a Python branch on a parameter not marked
static: ``torch.export`` raises on a data-dependent branch itself, and
``torch.compile`` guards on it and retraces, so there is no silent
wrong program for the lint to catch).

Traced code means: a function decorated with ``torch.compile`` or
``torch.jit.script`` (bare, called, or through ``functools.partial``), a
function whose NAME is handed to one of the entry points anywhere in the
same module (also through ``functools.partial`` / ``torch.func.grad`` /
``vmap`` / ``checkpoint`` or the ``FunctionModule`` that
``torch.export`` takes), the ``forward`` of a class of the module whose
instance is exported or compiled, the body of a ``with
torch.cuda.graph(...)`` block, plus everything lexically nested inside
one. Cross-module wrapping is invisible to a per-file AST pass — the
usual precision/recall trade; ``decode_step_cache_size()`` and the
kernels' launch counts have no such blind spot.

Runnable as ``python -m paddle_tpu_torch.analysis`` (the ``retrace``
pass) and over the whole tree in ``tests/test_torch_retrace_lint.py``.
Suppress a finding with ``# lint: allow`` on the offending line.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from paddle_tpu_torch.analysis.diagnostics import WARNING, Diagnostic
from paddle_tpu_torch.analysis.source_lint import (
    Reporter,
    default_roots,
    dotted,
    python_files,
    read_source,
)

__all__ = ["lint_retrace", "lint_file", "default_roots"]

# the entry points that trace a function into a program (resolved chains)
_TRACE_CALLS = ("torch.compile", "torch.export.export", "torch.jit.trace", "torch.jit.script",
                "torch.cuda.make_graphed_callables")
# the capture context whose body is traced
_CAPTURE_CALLS = ("torch.cuda.graph",)
# modules whose names an import may bind to one of the above
_TRACE_MODULES = ("torch", "torch.export", "torch.jit", "torch.cuda")
# wrappers to unwrap when hunting for the traced function's name:
# torch.compile(functools.partial(step, ...)), export(FunctionModule(fn))
_UNWRAP_NAMES = ("partial", "grad", "grad_and_value", "vjp", "vmap", "checkpoint",
                 "FunctionModule")
# trace-frozen environment reads
_ENV_READS = ("os.getenv", "os.environ.get")


class _Aliases(ast.NodeVisitor):
    """Pre-pass: local names bound by imports of torch's modules, and the
    module's classes, so ``from torch.export import export`` and ``import
    torch as th`` resolve to the dotted chains the rules match."""

    def __init__(self) -> None:
        self.names: Dict[str, str] = {}
        self.classes: Set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname and a.name in _TRACE_MODULES:
                self.names[a.asname] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module in _TRACE_MODULES:
            for a in node.names:
                self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes.add(node.name)
        self.generic_visit(node)


class _Index(ast.NodeVisitor):
    """Pre-pass: names of functions (and classes) handed to a trace entry
    point anywhere in the module."""

    def __init__(self, resolve, classes: Set[str]) -> None:
        self.resolve = resolve
        self.classes = classes
        self.traced: Set[str] = set()
        self.traced_classes: Set[str] = set()

    def visit_Call(self, node: ast.Call) -> None:
        if self.resolve(node.func) in _TRACE_CALLS and node.args:
            target = node.args[0]
            while isinstance(target, ast.Call):
                fn = dotted(target.func) or ""
                if fn in self.classes:  # its forward is traced, and what it wraps
                    self.traced_classes.add(fn)
                elif fn.rsplit(".", 1)[-1] not in _UNWRAP_NAMES:
                    break
                if not target.args:
                    break
                target = target.args[0]
            if isinstance(target, ast.Name):
                if target.id in self.classes:
                    self.traced_classes.add(target.id)
                else:
                    self.traced.add(target.id)
        self.generic_visit(node)


class _Linter(Reporter):
    def __init__(self, path: str, source_lines: List[str], resolve, index: _Index):
        super().__init__(path, source_lines)
        self.resolve = resolve
        self.index = index
        self._loop_depth = 0
        self._traced = False
        self._fn_locals: Set[str] = set()  # params + assigned names
        self._class: Optional[str] = None

    def _is_trace_decorated(self, node) -> bool:
        for dec in node.decorator_list:
            if self.resolve(dec) in _TRACE_CALLS:
                return True  # bare @torch.compile
            if isinstance(dec, ast.Call):
                if self.resolve(dec.func) in _TRACE_CALLS:
                    return True  # @torch.compile(mode=...)
                if (dotted(dec.func) or "").rsplit(".", 1)[-1] == "partial" and dec.args \
                        and self.resolve(dec.args[0]) in _TRACE_CALLS:
                    return True  # @functools.partial(torch.compile, ...)
        return False

    @staticmethod
    def _collect_locals(node) -> Set[str]:
        a = node.args
        names = {arg.arg for arg in a.posonlyargs + a.args + a.kwonlyargs
                 + ([a.vararg] if a.vararg else []) + ([a.kwarg] if a.kwarg else [])}
        names.update(n.id for n in ast.walk(node)
                     if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store))
        return names

    def visit_For(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = visit_For
    visit_AsyncFor = visit_For

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        saved, self._class = self._class, node.name
        self.generic_visit(node)
        self._class = saved

    def _visit_fn(self, node) -> None:
        traced = self._traced or self._is_trace_decorated(node) \
            or node.name in self.index.traced \
            or (node.name == "forward" and self._class in self.index.traced_classes)
        saved = (self._traced, self._fn_locals, self._loop_depth, self._class)
        # a def's body runs when CALLED, not where it appears: loop depth
        # does not propagate in
        self._loop_depth, self._class = 0, None
        if traced:
            self._fn_locals = self._fn_locals | self._collect_locals(node) if self._traced \
                else self._collect_locals(node)
            self._traced = True
        self.generic_visit(node)
        self._traced, self._fn_locals, self._loop_depth, self._class = saved

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node) -> None:
        saved, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = saved

    def visit_With(self, node: ast.With) -> None:
        capture = any(isinstance(item.context_expr, ast.Call)
                      and self.resolve(item.context_expr.func) in _CAPTURE_CALLS
                      for item in node.items)
        for item in node.items:
            self.visit(item)
        saved = (self._traced, self._fn_locals)
        if capture and not self._traced:
            # the captured body reads the enclosing function's names
            self._traced = True
            self._fn_locals = self._fn_locals | {
                n.id for stmt in node.body for n in ast.walk(stmt)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        for stmt in node.body:
            self.visit(stmt)
        self._traced, self._fn_locals = saved

    def visit_Call(self, node: ast.Call) -> None:
        chain = self.resolve(node.func)
        if chain in _TRACE_CALLS and self._loop_depth:
            self._diag("retrace-jit-in-loop",
                       f"{chain} called inside a loop body: each iteration builds a fresh "
                       "wrapper with an empty cache, so every iteration traces and compiles "
                       "again — hoist it out of the loop (or cache it keyed on the static "
                       "config)", node)
        if self._traced:
            self._check_traced_call(node)
        self.generic_visit(node)

    def _check_traced_call(self, node: ast.Call) -> None:
        chain = dotted(node.func) or ""
        last = chain.rsplit(".", 1)[-1] if chain else ""
        if chain in _ENV_READS or last == "flags":
            self._diag("retrace-config-read",
                       f"{chain or last}() inside traced code is read ONCE at trace time and "
                       "baked into the exported or captured program — flipping it later "
                       "silently does nothing; read the flag outside and pass it in", node)
        elif chain == "len" and node.args:
            target = node.args[0]
            capture = None
            if isinstance(target, ast.Name) and target.id not in self._fn_locals:
                capture = target.id
            elif isinstance(target, ast.Attribute):
                capture = dotted(target) or target.attr
            if capture is not None:
                self._diag("retrace-dynamic-len",
                           f"len({capture}) inside traced code measures a closure/attribute "
                           "capture: the length freezes at trace time, and when the captured "
                           "container changes the program is silently stale (or retraces per "
                           "size) — pass the data in as a traced argument", node,
                           severity=WARNING)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self._traced and dotted(node.value) == "os.environ":
            self._diag("retrace-config-read",
                       "os.environ[...] inside traced code is frozen at trace time — read "
                       "it outside and pass it in", node)
        self.generic_visit(node)


def lint_file(path: str, text: Optional[str] = None) -> List[Diagnostic]:
    """Retrace-lint one Python file."""
    tree, lines = read_source(path, text)
    if tree is None:
        return lines
    aliases = _Aliases()
    aliases.visit(tree)

    def resolve(node: ast.AST) -> Optional[str]:
        chain = dotted(node)
        if not chain:
            return None
        head, _, rest = chain.partition(".")
        full = aliases.names.get(head)
        return chain if full is None else (f"{full}.{rest}" if rest else full)

    index = _Index(resolve, aliases.classes)
    index.visit(tree)
    linter = _Linter(path, lines, resolve, index)
    linter.visit(tree)
    return linter.diags


def lint_retrace(paths: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Lint a set of files/directories (default: the paddle_tpu_torch package)."""
    return [d for path in python_files(paths) for d in lint_file(path)]
