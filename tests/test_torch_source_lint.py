"""The port's source lint (``paddle_tpu_torch/analysis/source_lint.py``)
against the JAX package's: every fixture text of ``tests/test_source_lint.py``
goes through both packages' ``lint_file``, as model/op code and as other
code, and both must give the same ``(code, severity, line)`` findings,
less the two rules the port's docstring names as not applicable
(``compat-import``, ``unguarded-export-import``: jax's version shims). The
port's own tree must lint clean, and the port's path detection must find
its model/op code.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import os

import pytest
from torch_lint_fixtures import ROOT, findings, fixtures

from paddle_tpu.analysis import source_lint as jlint
from paddle_tpu_torch.analysis import lint_file, lint_source
from paddle_tpu_torch.analysis import source_lint as tlint

NOT_APPLICABLE = ("compat-import", "unguarded-export-import")
FIXTURES = fixtures("test_source_lint.py")


def test_fixtures_found():
    assert len(FIXTURES) >= 20
    codes = set()
    for _, text in FIXTURES:
        codes |= {c for c, _, _ in findings(jlint.lint_file("fixture.py", text=text, traced=True))}
    # every rule of the JAX lint is exercised by some fixture
    assert codes >= {"compat-import", "unguarded-export-import", "traced-wallclock",
                     "traced-py-rng", "bare-assert", "metric-name", "span-name",
                     "fleet-metric-kind", "syntax-error"}


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("text", [t for _, t in FIXTURES], ids=[i for i, _ in FIXTURES])
def test_fixture_findings_match_jax(text, traced):
    want = findings(jlint.lint_file("fixture.py", text=text, traced=traced), NOT_APPLICABLE)
    got = tlint.lint_file("fixture.py", text=text, traced=traced)
    assert findings(got) == want
    assert not {d.code for d in got} & set(NOT_APPLICABLE)


def test_not_applicable_rules_named_in_the_docstring():
    for code in NOT_APPLICABLE:
        assert code in tlint.__doc__


def test_whole_tree_lints_clean():
    diags = lint_source()  # the paddle_tpu_torch package
    assert diags == [], "\n".join(str(d) for d in diags)
    assert os.path.samefile(tlint.default_roots()[0], ROOT / "paddle_tpu_torch")


@pytest.mark.parametrize("rel", ["ops/nn.py", "layers/attention.py", "models/resnet.py",
                                 "nets.py", "io.py", "serving/engine.py"])
def test_traced_path_detection_matches_jax(rel):
    for prefix in ("", f"{ROOT}/"):
        assert tlint._is_traced_path(f"{prefix}paddle_tpu_torch/{rel}") \
            == jlint._is_traced_path(f"{prefix}paddle_tpu/{rel}")


def test_traced_paths_of_the_port():
    pkg = ROOT / "paddle_tpu_torch"
    traced = {os.path.relpath(p, pkg) for p in tlint.python_files([str(pkg)])
              if tlint._is_traced_path(p)}
    for rel in ("ops/math.py", "ops/cuda/flash_attention.py", "layers/extended.py",
                "models/transformer_lm.py", "nets.py"):
        assert rel in traced
    # the nvcc builder times its builds and never runs inside a trace
    assert "ops/cuda/build.py" not in traced
    assert not any(r.startswith(("serving/", "parallel/", "core/")) for r in traced)


def test_port_messages_name_the_port():
    (d,) = lint_file("fixture.py", text="def f(x):\n    assert x\n")
    assert "paddle_tpu_torch.core.enforce.enforce()" in d.message
    (d,) = lint_file("fixture.py", text="import random\n\ndef f():\n    return random.random()\n",
                     traced=True)
    assert d.code == "traced-py-rng" and "torch.Generator" in d.message
    (d,) = lint_file("fixture.py", text="import time\n\ndef f():\n    return time.time()\n",
                     traced=True)
    assert d.code == "traced-wallclock" and "torch.export" in d.message
