"""Concurrency lint: AST checks for the locking discipline that
``paddle_tpu_torch.core.locks`` enforces at run time — port of
``paddle_tpu/analysis/concurrency_lint.py``, with all five of its rules.

The serving engines' loop, batcher, writer and router threads, the
Trainer's prefetcher and checkpoint writer and the elastic supervisor all
share locks. Two deadlock shapes recur — work invoked while a lock is
held, and a wait that can park forever — and a static pass catches them
at review time:

* ``raw-threading-lock`` — ``threading.Lock()`` / ``RLock()`` /
  ``Condition()`` constructed anywhere in the package outside
  ``core/locks.py`` itself: threaded subsystems use the named,
  instrumented ``core.locks`` wrappers so the lock-order detector and the
  held-locks registry see every lock;
* ``wait-without-timeout`` — zero-argument ``.wait()`` or ``.join()``
  (a condition, an event, a thread, a subprocess, a collective's work
  handle): an unbounded park cannot be woken by shutdown paths that race
  the waiter, nor by a peer or a compiler that never answers. Pass a
  timeout and re-check in a loop, or raise when it runs out;
* ``wait-without-predicate-loop`` — ``cond.wait(...)`` on a Condition
  not lexically inside a ``while``: stolen wakeups and ``notify_all``
  broadcasts make a bare wait return with the predicate still false;
* ``callback-under-lock`` — invoking a user callback / subscriber
  (``on_*`` / ``*callback*`` names) inside a ``with <lock>:`` body: the
  callback can re-enter the lock, or block while every other thread
  needs it. Collect under the lock, fire after release;
* ``blocking-io-under-lock`` — filesystem / sleep / subprocess / socket
  calls inside a ``with <lock>:`` body: every thread contending that lock
  then waits on the disk or the network.

Lock-ish context expressions are recognized by name (last dotted segment
containing ``lock``/``cond``/``mutex``): a lock named otherwise is hidden
from the lexical rules, the usual precision/recall trade of an AST lint;
the run-time order graph has no such blind spot.

Runnable as ``python -m paddle_tpu_torch.analysis`` and over the whole
tree in ``tests/test_torch_concurrency_lint.py``. Suppress a finding with
``# lint: allow`` on the offending line.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Set

from paddle_tpu_torch.analysis.diagnostics import Diagnostic
from paddle_tpu_torch.analysis.source_lint import (
    Reporter,
    default_roots,
    dotted,
    python_files,
    read_source,
)

__all__ = ["lint_concurrency", "lint_file", "default_roots"]

_RAW_PRIMITIVES = ("Lock", "RLock", "Condition")

# last-segment names that mark a with-context as "holding a lock"
_LOCKISH = ("lock", "cond", "mutex")

# dotted call chains that block on the filesystem / network / clock
_BLOCKING_CALLS = {
    "open", "time.sleep",
    "os.fsync", "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.makedirs", "os.rmdir", "os.listdir", "os.stat",
}
_BLOCKING_PREFIXES = ("subprocess.", "shutil.", "socket.", "urllib.", "requests.")


def _is_lockish(expr: ast.AST) -> bool:
    """Does this with-context expression look like a lock acquisition?
    Names/attributes whose last segment contains lock/cond/mutex
    (``self._lock``, ``cache_lock``, ``self._cond``), and calls on them."""
    chain = dotted(expr)
    if chain is None and isinstance(expr, ast.Call):
        chain = dotted(expr.func)
    if not chain:
        return False
    last = chain.rsplit(".", 1)[-1].lower()
    return any(k in last for k in _LOCKISH)


def _is_locks_module(path: str) -> bool:
    return os.path.normpath(path).endswith(os.path.join("core", "locks.py"))


class _CondNames(ast.NodeVisitor):
    """Pre-pass: names assigned from ``Condition(...)`` constructors (raw
    or ``core.locks``), so ``wait-without-predicate-loop`` does not fire
    on ``Event.wait`` / ``Thread.join`` / queue waits."""

    def __init__(self) -> None:
        self.names: Set[str] = set()

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call) \
                and (dotted(node.value.func) or "").rsplit(".", 1)[-1] == "Condition":
            for tgt in node.targets:
                chain = dotted(tgt)
                if chain:
                    self.names.add(chain.rsplit(".", 1)[-1])
        self.generic_visit(node)


class _Linter(Reporter):
    def __init__(self, path: str, source_lines: List[str], cond_names: Set[str]):
        super().__init__(path, source_lines)
        self.cond_names = cond_names
        self._while_depth = 0
        self._lock_depth = 0  # lexically inside a `with <lockish>:` body

    def visit_While(self, node: ast.While) -> None:
        self._while_depth += 1
        self.generic_visit(node)
        self._while_depth -= 1

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item)
        self._lock_depth += lockish
        for stmt in node.body:
            self.visit(stmt)
        self._lock_depth -= lockish

    # functions defined inside a with-block run LATER, not under the lock
    def _visit_fn(self, node) -> None:
        saved, self._lock_depth = self._lock_depth, 0
        self.generic_visit(node)
        self._lock_depth = saved

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn
    visit_Lambda = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        chain = dotted(node.func) or ""
        last = chain.rsplit(".", 1)[-1] if chain else ""

        if chain in tuple(f"threading.{p}" for p in _RAW_PRIMITIVES):
            self._diag("raw-threading-lock",
                       f"{chain}() bypasses the lock-order detector and the held-locks "
                       "registry; use the named core.locks wrapper "
                       f"(locks.{last}(name='subsystem.role'))", node)

        if last in ("wait", "join") and not node.args and not node.keywords \
                and isinstance(node.func, ast.Attribute):
            self._diag("wait-without-timeout",
                       f".{last}() with no timeout parks forever if the notifier races "
                       "shutdown, or a peer or a child process never answers; pass a "
                       "timeout and re-check the predicate in a loop (or raise)", node)

        if last == "wait" and isinstance(node.func, ast.Attribute):
            recv = dotted(node.func.value)
            if recv and recv.rsplit(".", 1)[-1] in self.cond_names and not self._while_depth:
                self._diag("wait-without-predicate-loop",
                           f"{recv}.wait() outside a while-predicate loop: notify_all "
                           "broadcasts and stolen wakeups return with the predicate still "
                           "false — use `while not pred: cond.wait(timeout)`", node)

        if self._lock_depth:
            if last.startswith("on_") or "callback" in last.lower():
                self._diag("callback-under-lock",
                           f"{chain or last}(...) invoked while holding a lock: the "
                           "callback can re-enter the lock or block every other thread; "
                           "collect under the lock, fire after release", node)
            elif chain in _BLOCKING_CALLS or chain.startswith(_BLOCKING_PREFIXES):
                self._diag("blocking-io-under-lock",
                           f"{chain}(...) inside a `with lock:` body serializes every "
                           "contending thread behind the disk/network; move the I/O "
                           "outside the critical section", node)
        self.generic_visit(node)


def lint_file(path: str, text: Optional[str] = None) -> List[Diagnostic]:
    """Lint one Python file for concurrency-discipline violations."""
    if _is_locks_module(path):
        return []  # the wrapper module itself owns the raw primitives
    tree, lines = read_source(path, text)
    if tree is None:
        return lines
    pre = _CondNames()
    pre.visit(tree)
    linter = _Linter(path, lines, pre.names)
    linter.visit(tree)
    return linter.diags


def lint_concurrency(paths: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Lint a set of files/directories (default: the paddle_tpu_torch package)."""
    return [d for path in python_files(paths) for d in lint_file(path)]
