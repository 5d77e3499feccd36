"""The port's retrace lint (``paddle_tpu_torch/analysis/retrace_lint.py``)
against the JAX package's. Every fixture text of ``tests/test_retrace_lint.py``
goes through the JAX ``lint_file`` as it is, and through the port's
translated to its PyTorch form (``jax.jit`` -> ``torch.compile``, on the
same lines): both must give the same ``(code, severity, line)`` findings,
less the two rules the port's docstring names as not applicable
(``retrace-dict-order``, ``retrace-missing-static``). Then the port's own
compile-once points: ``torch.export`` through ``FunctionModule`` (what
``io.save_inference_model`` and ``debugger.py`` export), an exported
class's ``forward``, capture under ``torch.cuda.graph``, imported
aliases. The port's tree must lint clean.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import textwrap

import pytest
from torch_lint_fixtures import ROOT, findings, fixtures

from paddle_tpu.analysis import retrace_lint as jlint
from paddle_tpu_torch.analysis import lint_retrace
from paddle_tpu_torch.analysis import retrace_lint as tlint

NOT_APPLICABLE = ("retrace-dict-order", "retrace-missing-static")
FIXTURES = fixtures("test_retrace_lint.py")


def to_torch(text: str) -> str:
    """A JAX fixture in its PyTorch form, line for line."""
    return (text.replace("jax.jit", "torch.compile").replace("import jax", "import torch")
            .replace("paddle_tpu.core", "paddle_tpu_torch.core"))


def _lint(code: str):
    return tlint.lint_file("snippet.py", textwrap.dedent(code))


def test_fixtures_found():
    assert len(FIXTURES) >= 18
    codes = set()
    for _, text in FIXTURES:
        codes |= {c for c, _, _ in findings(jlint.lint_file("snippet.py", text))}
    assert codes >= {"retrace-jit-in-loop", "retrace-config-read", "retrace-dynamic-len",
                     "retrace-missing-static", "retrace-dict-order", "syntax-error"}


@pytest.mark.parametrize("text", [t for _, t in FIXTURES], ids=[i for i, _ in FIXTURES])
def test_fixture_findings_match_jax(text):
    want = findings(jlint.lint_file("snippet.py", text), NOT_APPLICABLE)
    ported = to_torch(text)
    assert len(ported.splitlines()) == len(text.splitlines())
    assert findings(tlint.lint_file("snippet.py", ported)) == want
    # and the JAX spelling means nothing to the port's lint
    assert findings(tlint.lint_file("snippet.py", text)) <= {
        f for f in want if f[0] == "syntax-error"}


def test_not_applicable_rules_named_in_the_docstring():
    for code in NOT_APPLICABLE:
        assert code in tlint.__doc__


def test_export_through_function_module():
    # the shape of io.save_inference_model: a nested function exported
    # through the FunctionModule wrapper, in a loop over buckets
    diags = _lint("""
        import torch
        from paddle_tpu_torch.core.config import flags

        def save(model, buckets):
            def infer_fn(params, *a):
                if flags().check_nan_inf:
                    pass
                return model(params, *a)

            for b in buckets:
                program = torch.export.export(FunctionModule(infer_fn), (b,))
    """)
    assert sorted((d.code, int(d.where.rsplit(":", 1)[1])) for d in diags) == [
        ("retrace-config-read", 7), ("retrace-jit-in-loop", 12)]


def test_exported_class_forward_and_aliases():
    diags = _lint("""
        import os
        from torch.export import export
        import torch as th

        class Head(th.nn.Module):
            def forward(self, x):
                return x * len(self.table) + float(os.getenv("SCALE"))

            def helper(self):
                return os.getenv("FREE")

        program = export(Head(), (1,))
        fast = th.compile(lambda x: x)
    """)
    assert sorted(d.code for d in diags) == ["retrace-config-read", "retrace-dynamic-len"]


def test_cuda_graph_capture_body_is_traced():
    diags = _lint("""
        import os
        import torch

        def capture(step, queue):
            g = torch.cuda.CUDAGraph()
            n = 4
            with torch.cuda.graph(g):
                out = step(len(queue), n)
                scale = os.environ["SCALE"]
            before = os.environ["SCALE"]
            return g
    """)
    assert sorted((d.code, int(d.where.rsplit(":", 1)[1])) for d in diags) == [
        ("retrace-config-read", 10), ("retrace-dynamic-len", 9)]


def test_compile_decorators():
    diags = _lint("""
        import functools
        import os
        import torch

        @torch.compile
        def a(x):
            return os.getenv("A")

        @torch.compile(mode="reduce-overhead")
        def b(x):
            return os.getenv("B")

        @functools.partial(torch.compile, dynamic=False)
        def c(x):
            return os.getenv("C")

        @torch.jit.script
        def d(x):
            return os.getenv("D")

        def e(x):
            return os.getenv("E")
    """)
    assert [int(d.where.rsplit(":", 1)[1]) for d in diags] == [8, 12, 16, 20]


def test_the_port_compile_once_points_are_seen():
    # io.save_inference_model and debugger.py export through FunctionModule:
    # the lint must see what they trace, or a clean tree says nothing. A
    # config read planted in the traced function is found.
    for rel, head in (("io.py", "    def infer_fn(params, state, *a):\n"),
                      ("debugger.py", "        def fn(variables, *args):\n")):
        text = (ROOT / "paddle_tpu_torch" / rel).read_text()
        indent = " " * (len(head) - len(head.lstrip()) + 4)
        planted = text.replace(head, f"{head}{indent}os.getenv('X')\n", 1)
        assert planted != text
        assert tlint.lint_file(rel, text) == []
        assert [d.code for d in tlint.lint_file(rel, planted)] == ["retrace-config-read"], rel


def test_whole_tree_lints_clean():
    diags = lint_retrace()  # the paddle_tpu_torch package
    assert diags == [], "\n".join(str(d) for d in diags)
