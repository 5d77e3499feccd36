"""The fixture texts of the JAX package's lint tests, read from their
sources, so the port's lint tests hold both packages' lints to the same
findings on every one of them (and follow the JAX tests as they change).

A fixture is a string literal of the JAX test module that spans lines
(every fixture there ends its last line) and holds more than white space,
other than a docstring; it is dedented as the JAX tests dedent it.
Imports nothing of either package.
"""

import ast
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fixtures(test_file: str):
    """``[(id, text)]`` of the fixtures in ``tests/<test_file>``; ``id`` is
    ``<test function>:<line>`` of the literal."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text(), filename=test_file)
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                  and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    out = []
    for fn in tree.body:
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and "\n" in node.value and node.value.strip() and id(node) not in docstrings:
                name = getattr(fn, "name", "module")
                out.append((f"{name}:{node.lineno}", textwrap.dedent(node.value)))
    return out


def findings(diags, exclude=()):
    """``{(code, severity, line)}`` of file diagnostics (``where`` is
    ``path:line``), less the codes in ``exclude``."""
    return {(d.code, d.severity, int(d.where.rsplit(":", 1)[1])) for d in diags
            if d.code not in exclude}
