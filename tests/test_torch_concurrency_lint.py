"""The port's concurrency lint (``paddle_tpu_torch/analysis/concurrency_lint.py``)
against the JAX package's: every fixture text of
``tests/test_concurrency_lint.py`` goes through both packages'
``lint_file`` and both must give the same ``(code, severity, line)``
findings (all five rules apply to the port). The port's tree must lint
clean under the port's lint and under the JAX lint alike, with none of
the lock-discipline repairs done by a ``# lint: allow``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)

import pytest
from torch_lint_fixtures import ROOT, findings, fixtures

from paddle_tpu.analysis import concurrency_lint as jlint
from paddle_tpu_torch.analysis import lint_concurrency
from paddle_tpu_torch.analysis import concurrency_lint as tlint

FIXTURES = fixtures("test_concurrency_lint.py")
# the files of the lock-discipline repairs: raw locks replaced by named
# core.locks locks, unbounded waits bounded
REPAIRED = ("core/logging.py", "core/profiler.py", "ops/cuda/build.py", "parallel/collective.py")


def test_fixtures_found():
    assert len(FIXTURES) >= 15
    codes = set()
    for _, text in FIXTURES:
        codes |= {c for c, _, _ in findings(jlint.lint_file("fixture.py", text=text))}
    assert codes >= {"raw-threading-lock", "wait-without-timeout", "wait-without-predicate-loop",
                     "callback-under-lock", "blocking-io-under-lock", "syntax-error"}


@pytest.mark.parametrize("text", [t for _, t in FIXTURES], ids=[i for i, _ in FIXTURES])
def test_fixture_findings_match_jax(text):
    want = findings(jlint.lint_file("fixture.py", text=text))
    got = tlint.lint_file("fixture.py", text=text)
    assert findings(got) == want
    for d in got:  # location and offending source, as the JAX lint gives them
        assert d.where.startswith("fixture.py:")
        assert d.source or d.code == "syntax-error"


def test_locks_module_itself_exempt():
    src = "import threading\nlock = threading.Lock()\n"
    assert tlint.lint_file("paddle_tpu_torch/core/locks.py", text=src) == []
    assert [d.code for d in tlint.lint_file("paddle_tpu_torch/core/logging.py", text=src)] \
        == ["raw-threading-lock"]


def test_whole_tree_clean():
    diags = lint_concurrency()  # the paddle_tpu_torch package
    assert diags == [], "\n".join(str(d) for d in diags)


def test_jax_lint_finds_nothing_in_the_port():
    diags = jlint.lint_concurrency([str(ROOT / "paddle_tpu_torch")])
    assert diags == [], "\n".join(str(d) for d in diags)


@pytest.mark.parametrize("rel", REPAIRED)
def test_repairs_are_not_suppressions(rel):
    text = (ROOT / "paddle_tpu_torch" / rel).read_text()
    assert "# lint: allow" not in text
    assert "threading.Lock()" not in text
