"""``python -m paddle_tpu_torch.analysis``: one exit code over the passes
``source``, ``concurrency``, ``retrace`` and ``shard``, called in process.
The package's tree exits 0; a directory with one planted fault per
path-based pass exits 1 and reports each code; the ``shard`` pass fails on
a layout with a dead rule; ``--only`` restricts the run; ``--verify-program``
(the native verifier, ``ROADMAP.md`` item 8) is refused.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import re

import pytest

from paddle_tpu_torch.analysis.__main__ import PASSES, main

PLANTED = {
    "source": ("api.py", "def public(x):\n    assert x > 0\n    return x\n", "bare-assert"),
    "concurrency": ("worker.py", "import threading\nlock = threading.Lock()\n",
                    "raw-threading-lock"),
    "retrace": ("export.py", "import torch\nfor b in buckets:\n    f = torch.compile(step)\n",
                "retrace-jit-in-loop"),
}


@pytest.fixture
def planted(tmp_path):
    for name, text, _ in PLANTED.values():
        (tmp_path / name).write_text(text)
    return tmp_path


def _summary(out: str):
    m = re.search(r"paddle_tpu_torch\.analysis: (\d+) error\(s\), (\d+) warning\(s\)"
                  r"(?: \[(.*)\])?", out)
    assert m, out
    return int(m.group(1)), int(m.group(2)), m.group(3) or ""


def test_tree_exits_clean(capsys):
    assert main([]) == 0
    n_err, n_warn, detail = _summary(capsys.readouterr().out)
    assert (n_err, n_warn) == (0, 0)
    assert detail == "source=0, concurrency=0, retrace=0, shard=0"


def test_planted_faults_fail_each_pass(planted, capsys):
    assert main([str(planted)]) == 1
    out = capsys.readouterr().out
    for name, _, code in PLANTED.values():
        assert f"{name}:2: error[{code}]" in out or f"{name}:3: error[{code}]" in out, out
    n_err, _, detail = _summary(out)
    assert n_err == 3
    # the shard pass analyzes the model, not files: skipped with paths
    assert detail == "source=1, concurrency=1, retrace=1"


@pytest.mark.parametrize("only", sorted(set(PASSES) - {"shard"}))
def test_only_runs_one_pass(planted, only, capsys):
    assert main(["--only", only, str(planted)]) == 1
    out = capsys.readouterr().out
    assert _summary(out)[2] == f"{only}=1"
    for name, (_, _, code) in PLANTED.items():
        assert (code in out) == (name == only)


def test_only_clean_file_exits_zero(planted, capsys):
    assert main(["--only", "retrace", str(planted / "api.py")]) == 0
    assert _summary(capsys.readouterr().out) == (0, 0, "retrace=0")


def test_shard_pass_fails_on_a_dead_rule(monkeypatch, capsys):
    from paddle_tpu_torch.parallel.sharding import P
    from paddle_tpu_torch.serving import shardgroup

    bad = shardgroup.GroupLayout(rules=(("*/self_attn/qq/w", P(None, "tp")),))
    monkeypatch.setattr(shardgroup, "default_layout", lambda: bad)
    assert main(["--only", "shard"]) == 1
    out = capsys.readouterr().out
    assert "shard-dead-rule" in out and _summary(out)[2] == "shard=3"


def test_no_source_lint_runs_nothing(capsys):
    assert main(["--no-source-lint"]) == 0
    assert _summary(capsys.readouterr().out) == (0, 0, "")


def test_verify_program_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A item 8"):
        main(["--verify-program", str(tmp_path)])
