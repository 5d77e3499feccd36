"""CLI: ``python -m paddle_tpu_torch.analysis`` — port of
``paddle_tpu/analysis/__main__.py``.

One aggregated exit code over a registry of passes:

* ``source`` — repo-invariant AST lint (:mod:`.source_lint`);
* ``concurrency`` — locking-discipline AST lint (:mod:`.concurrency_lint`);
* ``retrace`` — compile-once retrace lint (:mod:`.retrace_lint`);
* ``shard`` — static sharding-layout analysis of the shipped
  ``default_layout()`` over ``transformer_lm`` at tp ∈ {1, 2, 4}
  (:mod:`.shard_analysis`, an init on the ``meta`` device; it analyzes
  the model, not files, so it is skipped when explicit paths are given).

``--only PASS`` (repeatable) restricts the run. ``--verify-program DIR``
(the native program verifier) raises ``NotImplementedError``: the native
export and its verifier are not ported yet (``ROADMAP.md`` §A item 8).
Exit status 1 when ANY selected pass produced an error-severity
diagnostic — one aggregated gate, not per-pass codes.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, format_diagnostics, has_errors

_SHARD_TPS = (1, 2, 4)


def _run_source(paths: Optional[Sequence[str]]) -> List[Diagnostic]:
    from paddle_tpu_torch.analysis.source_lint import lint_source

    return lint_source(paths or None)


def _run_concurrency(paths: Optional[Sequence[str]]) -> List[Diagnostic]:
    from paddle_tpu_torch.analysis.concurrency_lint import lint_concurrency

    return lint_concurrency(paths or None)


def _run_retrace(paths: Optional[Sequence[str]]) -> List[Diagnostic]:
    from paddle_tpu_torch.analysis.retrace_lint import lint_retrace

    return lint_retrace(paths or None)


def _run_shard(paths: Optional[Sequence[str]]) -> List[Diagnostic]:
    # model-based, not path-based: the shipped default layout at the tp
    # degrees the serving stack runs
    from paddle_tpu_torch.analysis.shard_analysis import analyze_model

    diags: List[Diagnostic] = []
    for tp in _SHARD_TPS:
        found, _report = analyze_model(tp=tp)
        diags.extend(found)
    return diags


# name -> (runner, path_based). Path-based passes lint the given files;
# the shard pass analyzes the model and only runs on whole-package checks.
PASSES: Dict[str, tuple] = {
    "source": (_run_source, True),
    "concurrency": (_run_concurrency, True),
    "retrace": (_run_retrace, True),
    "shard": (_run_shard, False),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="paddle_tpu_torch static analysis: " + ", ".join(PASSES),
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the paddle_tpu_torch package)")
    ap.add_argument("--only", action="append", choices=sorted(PASSES), default=None,
                    metavar="PASS",
                    help="run only this pass (repeatable): " + ", ".join(sorted(PASSES)))
    ap.add_argument("--verify-program", metavar="DIR", default=None,
                    help="verify an exported native program (not ported: raises)")
    ap.add_argument("--no-source-lint", action="store_true",
                    help="skip all lint passes")
    args = ap.parse_args(argv)
    if args.verify_program:
        raise NotImplementedError(
            "python -m paddle_tpu_torch.analysis --verify-program: the native program export "
            "(native/) and its verifier (analysis/verifier.py) are not ported to "
            "paddle_tpu_torch yet (ROADMAP.md §A item 8)")

    selected = list(args.only) if args.only else list(PASSES)
    if args.no_source_lint and not args.only:
        selected = []

    diags: List[Diagnostic] = []
    by_pass: Dict[str, int] = {}
    for name in selected:
        runner, path_based = PASSES[name]
        if not path_based and args.paths and not args.only:
            continue  # model-based pass on a file-list invocation
        found = runner(args.paths or None)
        by_pass[name] = len(found)
        diags.extend(found)

    if diags:
        print(format_diagnostics(diags))
    n_err = sum(1 for d in diags if d.severity == "error")
    detail = ", ".join(f"{k}={v}" for k, v in by_pass.items())
    print(f"paddle_tpu_torch.analysis: {n_err} error(s), {len(diags) - n_err} warning(s)"
          + (f" [{detail}]" if detail else ""))
    return 1 if has_errors(diags) else 0


if __name__ == "__main__":
    sys.exit(main())
