"""The port's ``fluid_benchmark`` CLI (``paddle_tpu_torch.benchmark``)
against the JAX package's (``paddle_tpu.benchmark``), on the CPU
(``--device CPU``): the cases of ``tests/test_dataset_benchmark.py``'s CLI
tests, and the MNIST net's last loss with the JAX CLI's initial weights
carried across (``--no_random``, f32, 3 Adam steps) at rtol 1e-4 (f32
products summed in other orders over three steps).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import numpy as np
import pytest

from paddle_tpu import benchmark as jbench
from paddle_tpu import models as jmodels
from paddle_tpu_torch import benchmark as tbench
from paddle_tpu_torch import convert, framework
from paddle_tpu_torch import models as tmodels

LOSS_RTOL = 1e-4
MNIST = ["--model", "mnist", "--batch_size", "16", "--iterations", "2",
         "--skip_batch_num", "1", "--json", "--no_random"]


def test_mnist_record_and_loss_match_the_jax_cli(capsys):
    jrec = jbench.main(MNIST + ["--device", "CPU"])
    # the JAX CLI's initial weights: Model.init(0) on its seed-0 batch
    jspec = jmodels.get_model("mnist", learning_rate=0.001)
    batch = jspec.synth_batch(16, np.random.RandomState(0))
    jvars = jax.jit(lambda *b: jspec.model.init(0, *b))(*batch)  # = the eager init
    carried = framework.Variables(convert.params_from_jax(jvars.params, "cpu"),
                                  convert.params_from_jax(jvars.state, "cpu"))
    rec = tbench.run_benchmark(tbench.parse_args(MNIST + ["--device", "CPU"]),
                               variables=carried)
    assert rec.keys() == jrec.keys()
    assert rec["unit"] == jrec["unit"] == "images/sec"
    assert (rec["model"], rec["batch_size"], rec["chips"]) == ("mnist", 16, 1)
    assert rec["examples_per_sec"] > 0
    np.testing.assert_allclose(rec["last_loss"], jrec["last_loss"], rtol=LOSS_RTOL)
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(printed) == 2  # one JSON line a pass from each CLI


def test_zero_skip_infer_only_and_profile(tmp_path, capsys):
    rec = tbench.main(["--model", "mnist", "--batch_size", "8", "--iterations", "2",
                       "--skip_batch_num", "0", "--no_random", "--device", "CPU"])
    assert np.isfinite(rec["last_loss"])
    rec = tbench.main(["--model", "mnist", "--batch_size", "8", "--iterations", "2",
                       "--skip_batch_num", "1", "--no_random", "--device", "CPU",
                       "--infer_only", "--profile", "--profile_dir", str(tmp_path)])
    assert np.isfinite(rec["last_loss"])
    out = capsys.readouterr().out
    assert "benchmark.step_dispatch" in out and "benchmark.device_wait" in out
    assert (tmp_path / "trace.chrome.json").exists()
    assert (tmp_path / "timeline.chrome.json").exists()


def test_two_gloo_ranks():
    rec = tbench.main(["--model", "mnist", "--batch_size", "16", "--iterations", "2",
                       "--skip_batch_num", "1", "--gpus", "2", "--no_random",
                       "--device", "CPU"])
    assert rec["chips"] == 2 and np.isfinite(rec["last_loss"])


def test_scan_and_moe_flags(monkeypatch):
    """--scan_layers / --moe_experts reach get_model for the transformer
    families only (plumbing, as the JAX test checks it); the MoE LM then
    trains through the CLI (at a small width: the CLI's own is BASE_CFG)."""
    captured = {}

    class _Abort(Exception):
        pass

    def fake_get_model(name, **cfg):
        captured[name] = cfg
        raise _Abort

    with monkeypatch.context() as m:
        m.setattr(tmodels, "get_model", fake_get_model)
        for argv in (["--model", "transformer_lm", "--scan_layers", "--moe_experts", "4"],
                     ["--model", "resnet", "--scan_layers"]):
            with pytest.raises(_Abort):
                tbench.run_benchmark(tbench.parse_args(argv + ["--device", "CPU"]))
    cfg = captured["transformer_lm"]
    assert cfg["scan_layers"] is True and cfg["moe_experts"] == 4
    assert "scan_layers" not in captured["resnet"]
    assert captured["resnet"]["image_size"] == 224 and captured["resnet"]["class_dim"] == 102
    real = tmodels.get_model
    small = dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=2)
    with monkeypatch.context() as m:
        m.setattr(tmodels, "get_model", lambda name, **cfg: real(name, **cfg, **small))
        rec = tbench.main(["--model", "transformer_lm", "--moe_experts", "4", "--batch_size",
                           "2", "--iterations", "2", "--skip_batch_num", "0", "--no_random",
                           "--device", "CPU"])
    assert rec["model"] == "transformer_lm" and np.isfinite(rec["last_loss"])


def test_refusals_and_defaults():
    with pytest.raises(NotImplementedError, match="item 10"):
        tbench.main(MNIST + ["--use_real_data", "--device", "CPU"])
    args, jargs = tbench.parse_args([]), jbench.parse_args([])
    for name in ("model", "batch_size", "learning_rate", "skip_batch_num", "iterations",
                 "pass_num", "chips", "data_set", "update_method", "moe_experts"):
        assert getattr(args, name) == getattr(jargs, name), name
    assert (args.model, args.skip_batch_num, args.iterations) == ("resnet", 5, 80)
    assert args.device == "GPU" and jargs.device == "TPU"
    assert tbench.BENCHMARK_MODELS == jbench.BENCHMARK_MODELS
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(MNIST)  # the card by default
