"""The port's checkpoints (``paddle_tpu_torch.checkpoint``) on the CPU: the
integrity cases of ``tests/test_resilience.py`` ported (CRC fallback and
quarantine, a truncated npz, all serials corrupt, a save retried after an
injected IO error), the copied resilience helpers, and the format shared
with the JAX package — the same leaves in the same order, so a checkpoint
written by either package resumes in the other.

Tolerances: leaves written by the two packages from the same state are
equal exactly; training continued in the other package after a resume
matches training continued in the same package at rtol 1e-5 on the losses
and atol 1e-5 on every leaf (the linear-regression model and reader of
``tests/test_torch_trainer.py``, Adam at lr 0.05; and a conv + BatchNorm
net, whose BN moving statistics are checkpoint leaves, Momentum at lr
0.01).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import checkpoint as jckpt
from paddle_tpu import trainer as jtrainer
from paddle_tpu_torch import checkpoint as ckpt_mod
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.retry import retry_call
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.optimizer import OptState
from paddle_tpu_torch.resilience import faults, integrity
from paddle_tpu_torch.resilience.integrity import CheckpointCorruptError
from paddle_tpu_torch.resilience.watchdog import StepWatchdog
from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()


def _save_serials(root, n=3):
    tree = {"w": torch.arange(6, dtype=torch.float32), "b": torch.tensor(1.0)}
    for step in range(n):
        tree["w"] = tree["w"] + 1
        ckpt_mod.save_checkpoint(root, tree, step=step, max_num_checkpoints=10)
    return tree


def test_checkpoint_crc_fallback_and_quarantine(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _save_serials(root, n=3)
    npz = glob.glob(os.path.join(ckpt_mod.latest_checkpoint(root), "*.npz"))[0]
    with open(npz, "r+b") as f:  # flip bytes mid-file: CRC must catch it
        f.seek(os.path.getsize(npz) // 2)
        f.write(b"\xde\xad\xbe\xef")
    loaded, meta = ckpt_mod.load_checkpoint(root, tree)
    assert meta["step"] == 1  # fell back to the previous good serial
    assert torch.equal(loaded["w"], torch.arange(6, dtype=torch.float32) + 2)
    assert any(".corrupt" in d for d in os.listdir(root))
    assert ckpt_mod.latest_checkpoint(root).endswith("checkpoint_1")


def test_checkpoint_truncated_npz_detected(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _save_serials(root, n=2)
    npz = glob.glob(os.path.join(ckpt_mod.latest_checkpoint(root), "*.npz"))[0]
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    _, meta = ckpt_mod.load_checkpoint(root, tree)
    assert meta["step"] == 0


def test_checkpoint_all_corrupt_raises(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _save_serials(root, n=2)
    for npz in glob.glob(os.path.join(root, "checkpoint_*", "*.npz")):
        with open(npz, "wb") as f:
            f.write(b"garbage")
    with pytest.raises(EnforceError, match="all candidates corrupt"):
        ckpt_mod.load_checkpoint(root, tree)


def test_checkpoint_save_retries_injected_io_error(tmp_path):
    tree = {"w": torch.ones(4)}
    with faults.injected(faults.FaultSpec(faults.CHECKPOINT_SAVE, "error", times=1)) as plan:
        path = ckpt_mod.save_checkpoint(str(tmp_path / "ckpt"), tree, step=0)
    assert plan.stats()[faults.CHECKPOINT_SAVE] == 1  # it DID fail once
    loaded, _ = ckpt_mod.load_checkpoint(path, tree)  # and published anyway
    assert torch.equal(loaded["w"], torch.ones(4))


def test_checkpoint_refuses_bf16_leaf(tmp_path):
    with pytest.raises(EnforceError, match="bfloat16"):
        ckpt_mod.save_checkpoint(str(tmp_path), {"w": torch.ones(2, dtype=torch.bfloat16)}, step=0)


def test_integrity_verify_crc_roundtrip(tmp_path):
    p = str(tmp_path / "blob.bin")
    with open(p, "wb") as f:
        f.write(b"x" * 100_000)
    crc = integrity.crc32_file(p)
    integrity.verify_crc(p, crc, what="blob")
    with pytest.raises(CheckpointCorruptError, match="crc32 mismatch"):
        integrity.verify_crc(p, crc ^ 1, what="blob")
    q = integrity.quarantine(p)
    assert q.endswith(".corrupt") and not os.path.exists(p)


def test_retry_call_recovers_and_exhausts():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, retries=3, sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and len(sleeps) == 2 and sleeps[0] < sleeps[1]
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("down")), retries=1, sleep=lambda s: None)


def test_step_watchdog_dumps_on_stall_only():
    stalls = []
    wd = StepWatchdog(timeout_s=0.1, on_stall=lambda tag, el: stalls.append(tag))
    try:
        with wd.watch("fast"):
            pass
        time.sleep(0.25)
        assert wd.stalls == 0 and stalls == []
        with wd.watch("slow step"):
            time.sleep(0.4)
        assert wd.stalls == 1 and stalls == ["slow step"]
    finally:
        wd.close()


# ---- one format for both packages ------------------------------------------


def _numpy_state(seed=0):
    """A (params, state, step, Adam slots) training state as numpy."""
    rng = np.random.RandomState(seed)
    params = {"b/fc/w": rng.randn(3, 2).astype(np.float32), "a/fc/b": rng.randn(2).astype(np.float32)}
    slots = {s: {k: rng.rand(*v.shape).astype(np.float32) for k, v in params.items()}
             for s in ("moment2", "moment1")}
    return params, 7, slots


def test_same_leaves_in_the_same_order_as_jax(tmp_path):
    params, step, slots = _numpy_state()
    jtree = (jpt.framework.Variables({k: jnp.asarray(v) for k, v in params.items()}, {}),
             jpt.optimizer.OptState(jnp.asarray(step, jnp.int32),
                                    {s: {k: jnp.asarray(v) for k, v in d.items()}
                                     for s, d in slots.items()}))
    ttree = convert.train_state_from_jax(jtree, "cpu")
    assert isinstance(ttree[0], Variables) and isinstance(ttree[1], OptState)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jtree, step=3, epoch=1)
    tpath = ckpt_mod.save_checkpoint(str(tmp_path / "torch"), ttree, step=3, epoch=1)
    with np.load(os.path.join(jpath, "shard_0.npz")) as jz, \
            np.load(os.path.join(tpath, "shard_0.npz")) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for name in jz.files:
            assert jz[name].dtype == tz[name].dtype and jz[name].shape == tz[name].shape, name
            np.testing.assert_array_equal(jz[name], tz[name], err_msg=name)
        assert tz["leaf_2"].dtype == np.int32 and tz["leaf_2"].shape == ()  # OptState.step
    jmeta = json.load(open(os.path.join(jpath, "checkpoint.json")))
    tmeta = json.load(open(os.path.join(tpath, "checkpoint.json")))
    for key in ("step", "epoch", "serial", "num_leaves", "trainer_id"):
        assert tmeta[key] == jmeta[key], key
    assert set(tmeta["crc32"]) == set(jmeta["crc32"]) == {"shard_0.npz"}
    # each package loads the other's file
    loaded, _ = ckpt_mod.load_checkpoint(jpath, ttree)
    assert loaded[1].step == 7
    np.testing.assert_array_equal(loaded[0].params["b/fc/w"].numpy(), params["b/fc/w"])
    jloaded, _ = jckpt.load_checkpoint(tpath, jtree)
    assert int(jloaded[1].step) == 7
    np.testing.assert_array_equal(np.asarray(jloaded[1].slots["moment2"]["a/fc/b"]),
                                  slots["moment2"]["a/fc/b"])


def _linreg(pkg, mean):
    def model():
        def net(x, y):
            return mean(pkg.ops.nn.square_error_cost(pkg.layers.fc(x, size=1), y))

        return net

    return model


def _reader():
    def reader():
        rng = np.random.RandomState(0)
        w = np.array([[2.0], [-1.0], [0.5], [3.0]], np.float32)
        for _ in range(2):
            x = rng.randn(8, 4).astype(np.float32)
            yield x, x @ w + 0.1

    return reader


def _convbn(pkg, mean):
    def model():
        def net(x, y):
            h = pkg.layers.batch_norm(pkg.layers.conv2d(x, 4, 3, padding=1), act="relu")
            return mean(pkg.ops.nn.square_error_cost(pkg.layers.fc(h, size=1), y))

        return net

    return model


def _image_reader():
    def reader():
        rng = np.random.RandomState(0)
        for _ in range(2):
            x = rng.rand(8, 5, 5, 2).astype(np.float32)
            yield x, x.sum(axis=(1, 2, 3))[:, None] * 0.1

    return reader


def _make(pkg_name, root, net="linreg"):
    cfg_cls = CheckpointConfig if pkg_name == "torch" else jtrainer.CheckpointConfig
    cfg = cfg_cls(root, step_interval=2, max_num_checkpoints=4)
    pkg, mean = (pt, torch.mean) if pkg_name == "torch" else (jpt, jnp.mean)
    if net == "linreg":
        model, opt = _linreg(pkg, mean), lambda: pkg.optimizer.Adam(learning_rate=0.05)
    else:
        model = _convbn(pkg, mean)
        opt = lambda: pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9)  # noqa: E731
    if pkg_name == "torch":
        return Trainer(model, opt, place="cpu", checkpoint_config=cfg)
    return jtrainer.Trainer(model, opt, checkpoint_config=cfg)


def _train(t, epochs, reader=None):
    losses = []
    t.train(num_epochs=epochs, reader=reader or _reader(),
            event_handler=lambda ev: losses.append(ev.metrics)
            if type(ev).__name__ == "EndStepEvent" else None)
    return losses


@pytest.mark.parametrize("writer, reader_pkg", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer, reader_pkg):
    """One package trains 2 steps (one epoch) and saves; a fresh Trainer of
    the other package auto-resumes from that serial alone and trains 2
    more, matching the writer continuing on its own."""
    root = str(tmp_path / "ckpt")
    first = _make(writer, root)
    losses = _train(first, 2)  # saves after step 2 (epoch 0) and step 4
    assert first.global_step == 4 and len(losses) == 4
    cont_losses = losses[2:]  # the writer continuing past the step-2 save
    state_cont = (first.variables, first.opt_state)

    resume_root = str(tmp_path / "resume")
    os.makedirs(resume_root)
    os.rename(os.path.join(root, "checkpoint_0"), os.path.join(resume_root, "checkpoint_0"))
    resumed = _make(reader_pkg, resume_root)
    res_losses = _train(resumed, 2)
    assert resumed.global_step == 4 and len(res_losses) == 2
    np.testing.assert_allclose(res_losses, cont_losses, rtol=1e-5)
    a = convert.train_state_leaves((resumed.variables, resumed.opt_state)) if reader_pkg == "torch" \
        else [np.asarray(l) for l in jax.tree_util.tree_leaves((resumed.variables, resumed.opt_state))]
    b = convert.train_state_leaves(state_cont) if writer == "torch" \
        else [np.asarray(l) for l in jax.tree_util.tree_leaves(state_cont)]
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=f"leaf {i}")


@pytest.mark.parametrize("writer, reader_pkg", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_checkpoint_with_bn_state_resumes_in_the_other_package(tmp_path, writer, reader_pkg):
    """As above, for a model with BatchNorm state: the moving statistics are
    checkpoint leaves (after the parameters, by name) in both packages, and
    the resumed run continues them."""
    root = str(tmp_path / "ckpt")
    first = _make(writer, root, net="convbn")
    losses = _train(first, 2, _image_reader())
    assert first.global_step == 4 and len(losses) == 4
    assert sorted(first.variables.state) == ["batch_norm/moving_mean", "batch_norm/moving_variance"]
    state_cont = (first.variables, first.opt_state)

    resume_root = str(tmp_path / "resume")
    os.makedirs(resume_root)
    os.rename(os.path.join(root, "checkpoint_0"), os.path.join(resume_root, "checkpoint_0"))
    resumed = _make(reader_pkg, resume_root, net="convbn")
    res_losses = _train(resumed, 2, _image_reader())
    assert resumed.global_step == 4 and len(res_losses) == 2
    np.testing.assert_allclose(res_losses, losses[2:], rtol=1e-5)
    a = convert.train_state_leaves((resumed.variables, resumed.opt_state)) if reader_pkg == "torch" \
        else [np.asarray(l) for l in jax.tree_util.tree_leaves((resumed.variables, resumed.opt_state))]
    b = convert.train_state_leaves(state_cont) if writer == "torch" \
        else [np.asarray(l) for l in jax.tree_util.tree_leaves(state_cont)]
    assert len(a) == len(b) == 6 + 2 + 1 + 6  # 6 params, 2 BN statistics, step, 6 velocities
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=f"leaf {i}")
