"""The PyTorch/CUDA port stands alone: no file of ``paddle_tpu_torch/``, nor
``chip_smoke.py`` or the port's tools (``tools/torch_*.py``), imports ``jax``
or the JAX package ``paddle_tpu`` (not even one of its jax-free modules),
checked on the source's AST so that imports inside functions count too, and
every module of the port imports in a fresh interpreter where ``jax`` and
``paddle_tpu`` cannot be imported. Only the tests import both."""

import torch_threads  # noqa: F401  (first: its share of the cores)
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "tools").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "paddle_tpu_torch/ops/cuda/flash_attention.py" in names
    assert "paddle_tpu_torch/models/transformer_lm.py" in names
    for module in ("optimizer", "backward", "lr_scheduler", "regularizer", "clip"):
        assert f"paddle_tpu_torch/{module}.py" in names
    assert "chip_smoke.py" in names and "tools/torch_profile_generate.py" in names
    assert "tools/torch_time_flash.py" in names
    for module in ("trainer", "executor", "checkpoint", "io", "metrics", "nets", "reader/__init__",
                   "reader/feeder", "dataset/digits", "models/mnist", "resilience/faults",
                   "observability/runlog", "core/profiler", "core/retry", "core/locks",
                   "concurrency", "observability/metrics", "tracing/waterfall", "serving/__init__",
                   "serving/kv_cache", "serving/prefix_cache", "serving/scheduler",
                   "serving/admission", "serving/metrics", "serving/engine", "serving/recovery",
                   "serving/decode", "core/config", "analysis/diagnostics", "observability/mfu",
                   "observability/roofline", "observability/exporter",
                   "observability/flight_recorder", "observability/__init__",
                   "tracing/__init__", "tracing/context", "tracing/memory", "tracing/straggler",
                   "tracing/export", "watch/__init__", "watch/detectors", "watch/alerts",
                   "watch/baseline", "watch/slo", "watch/watcher", "serving/buckets",
                   "serving/batcher", "inferencer", "transpiler/inference",
                   "transpiler/memory", "benchmark", "tensor", "average", "evaluator",
                   "debugger", "parallel/pipeline"):
        assert f"paddle_tpu_torch/{module}.py" in names, module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_paddle_tpu(path):
    bad = [
        f"{path.relative_to(ROOT)}:{line} imports {mod}"
        for line, mod in _imported_roots(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, "\n".join(bad)


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\n"
        "def f():\n"
        "    from paddle_tpu.core import enforce\n"
        "    import importlib\n"
        "    return importlib.import_module('paddle_tpu.ops')\n"
        "from paddle_tpu_torch import framework\n"
    )
    roots = [m.split(".")[0] for _, m in _imported_roots(src)]
    assert roots.count("jax") == 1 and roots.count("paddle_tpu") == 2
    assert "paddle_tpu_torch" in roots


def test_every_module_imports_with_jax_and_paddle_tpu_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES if p.is_relative_to(ROOT / "paddle_tpu_torch"))
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "for name in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print(len([m for m in sys.modules if m.startswith('paddle_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= len(modules)
