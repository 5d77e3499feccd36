"""The port's Trainer (``paddle_tpu_torch.trainer``) on the CPU: the
non-parallel cases of ``tests/test_trainer.py`` and the Trainer cases of
``tests/test_resilience.py`` ported, then the port's Trainer against the
JAX package's on the same weights and the same reader.

Tolerances: the linear-regression model (4 inputs, one output, mean
squared error) over 3 epochs of 4 batches, SGD (lr 0.1) and Adam (lr 0.05,
the JAX tests' rate): per-step losses at rtol 1e-5 and every leaf of the
final training state (parameters and Adam slots) at atol 1e-5 — the two
packages' f32 products sum in other orders. The small LM (as in
``tests/test_torch_train_step.py``) through 3 Trainer steps: that file's
tolerances — losses at rtol 1e-5, parameters at atol 1e-4 (the k biases,
whose gradients are rounding noise, at the 3 * lr three Adam steps can
move them), Adam slots at rtol 1e-4, atol 1e-7. A prefetched run equals an
unprefetched one exactly.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import models as jmodels
from paddle_tpu import trainer as jtrainer
from paddle_tpu.core import config as jconfig
from paddle_tpu_torch import checkpoint as ckpt_mod
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.config import set_flags
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.resilience import ResilienceConfig, faults
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.observability import ObservabilityConfig
from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer
from paddle_tpu_torch.watch import WatchConfig

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()


def _linreg_model():
    def net(x, y):
        pred = pt.layers.fc(x, size=1)
        return torch.mean(pt.ops.nn.square_error_cost(pred, y))

    return net


def _jax_linreg_model():
    def net(x, y):
        pred = jpt.layers.fc(x, size=1)
        return jnp.mean(jpt.ops.nn.square_error_cost(pred, y))

    return net


def _reader(n_batches=4, bs=8, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.array([[2.0], [-1.0], [0.5], [3.0]], np.float32)
        for _ in range(n_batches):
            x = rng.randn(bs, 4).astype(np.float32)
            yield x, x @ w + 0.1

    return reader


def _sgd():
    return pt.optimizer.SGD(learning_rate=0.1)


def _trainer(**kw):
    return Trainer(_linreg_model, _sgd, place="cpu", **kw)


def _losses(out):
    return lambda ev: out.append(ev.metrics) if isinstance(ev, EndStepEvent) else None


# ---- tests/test_trainer.py, non-parallel cases ----------------------------


def test_trainer_loss_decreases_and_events_fire():
    events, losses = [], []
    trainer = _trainer()

    def handler(ev):
        events.append(type(ev).__name__)
        if isinstance(ev, EndStepEvent):
            losses.append(ev.metrics)

    trainer.train(num_epochs=3, event_handler=handler, reader=_reader())
    assert losses[-1] < losses[0]
    assert events[0] == "BeginEpochEvent"
    assert events.count("BeginEpochEvent") == 3
    assert events.count("EndEpochEvent") == 3
    assert events.count("BeginStepEvent") == 12
    assert np.isfinite(trainer.test(_reader(n_batches=2, seed=1)))
    assert trainer.variables.params["fc/w"].device.type == "cpu"
    assert prof.histograms()["trainer.step_seconds"]["count"] >= 12


def test_trainer_checkpoint_and_auto_resume(tmp_path):
    root = str(tmp_path / "ckpt")
    cfg = CheckpointConfig(root, max_num_checkpoints=2, step_interval=2)
    adam = lambda: pt.optimizer.Adam(learning_rate=0.05)  # noqa: E731
    t1 = Trainer(_linreg_model, adam, place="cpu", checkpoint_config=cfg)
    t1.train(num_epochs=2, reader=_reader())
    assert t1.global_step == 8
    saved_param = t1.variables.params["fc/w"].clone()

    # a fresh trainer resumes from the checkpoint dir and does NOT re-train
    # completed epochs
    t2 = Trainer(_linreg_model, adam, place="cpu", checkpoint_config=cfg)
    steps = []
    t2.train(num_epochs=2, reader=_reader(),
             event_handler=lambda ev: steps.append(ev) if isinstance(ev, EndStepEvent) else None)
    assert steps == []
    assert t2.global_step == 8 and t2.epoch == 2
    assert torch.equal(t2.variables.params["fc/w"], saved_param)
    assert t2.opt_state.step == t1.opt_state.step == 8

    # a third epoch trains exactly 4 more steps
    t2.train(num_epochs=3, reader=_reader(),
             event_handler=lambda ev: steps.append(ev) if isinstance(ev, EndStepEvent) else None)
    assert len(steps) == 4 and t2.global_step == 12
    serials = [d for d in os.listdir(root) if d.startswith("checkpoint_")]
    assert len(serials) <= 2  # pruning


def test_trainer_save_params(tmp_path):
    trainer = _trainer()
    trainer.train(num_epochs=1, reader=_reader(n_batches=2))
    out = str(tmp_path / "params")
    trainer.save_params(out)
    loaded = pt.io.load_params(out, device="cpu")
    assert torch.equal(loaded.params["fc/w"], trainer.variables.params["fc/w"])
    # the JAX package reads the same files
    jloaded = jpt.io.load_params(out)
    np.testing.assert_array_equal(np.asarray(jloaded.params["fc/w"]),
                                  trainer.variables.params["fc/w"].numpy())


_PREEMPT_CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import paddle_tpu_torch as pt
from paddle_tpu_torch.trainer import Trainer, CheckpointConfig

ckpt_dir, slow = sys.argv[1], sys.argv[2] == "slow"

def train_func():
    def net(x, y):
        pred = pt.layers.fc(x, size=1)
        return torch.mean((pred[:, 0] - y) ** 2)
    return net

rng = np.random.RandomState(0)
x = rng.randn(16, 4).astype(np.float32)
y = rng.randn(16).astype(np.float32)

def reader():
    for _ in range(50):
        if slow:
            time.sleep(0.2)  # give the parent a window to SIGTERM us
        yield (x, y)

t = Trainer(train_func, lambda: pt.optimizer.SGD(learning_rate=0.1), place="cpu",
            checkpoint_config=CheckpointConfig(ckpt_dir, step_interval=1000))

def handler(ev):
    name = type(ev).__name__
    if name == "BeginEpochEvent":
        print("START_STEP", t.global_step, flush=True)
    if slow and name == "EndStepEvent":
        print("STEP", ev.step, flush=True)

t.train(num_epochs=1, reader=reader, event_handler=handler)
print("END", t.global_step, "PREEMPTED" if t.preempted else "DONE", flush=True)
"""


def test_trainer_preemption_save_and_resume(tmp_path):
    """SIGTERM a training subprocess mid-epoch → it checkpoints and exits
    cleanly; a restarted process resumes from the saved step."""
    ckpt = str(tmp_path / "ckpt")
    script = _PREEMPT_CHILD.format(repo=REPO)
    p = subprocess.Popen([sys.executable, "-c", script, ckpt, "slow"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen = []
    deadline = time.time() + 120
    while time.time() < deadline:
        line = p.stdout.readline()
        if not line:
            break
        seen.append(line)
        if line.startswith("STEP") and int(line.split()[1]) >= 2:
            break
    p.send_signal(signal.SIGTERM)
    rest, err = p.communicate(timeout=120)
    out = "".join(seen) + rest
    assert p.returncode == 0, (out[-500:], err[-500:])
    assert "PREEMPTED" in out, out
    saved_step = int([l for l in out.splitlines() if l.startswith("END")][0].split()[1])
    assert 0 < saved_step < 50, out

    r = subprocess.run([sys.executable, "-c", script, ckpt, "fast"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-500:])
    start = int([l for l in r.stdout.splitlines() if l.startswith("START_STEP")][0].split()[1])
    assert start == saved_step, (start, saved_step)
    assert "DONE" in r.stdout, r.stdout


def test_in_step_nan_guard_raises():
    """With check_nan_inf on, the step itself reports whether its loss and
    gradients are finite, and the default policy raises."""
    def bad_reader():
        yield np.full((8, 4), np.inf, np.float32), np.zeros((8, 1), np.float32)

    set_flags(check_nan_inf=True)
    try:
        trainer = _trainer()
        with pytest.raises(EnforceError, match="check_nan_inf"):
            trainer.train(num_epochs=1, event_handler=lambda ev: None, reader=bad_reader)
        out = trainer._run_step((np.zeros((8, 4), np.float32), np.zeros((8, 1), np.float32)))
        assert out.finite is not None and bool(out.finite)
    finally:
        set_flags(check_nan_inf=False)


def test_trainer_prefetch_matches_plain():
    """prefetch=True must not change the training trajectory (bit-equal)."""
    def run(prefetch):
        losses = []
        _trainer(prefetch=prefetch).train(num_epochs=2, event_handler=_losses(losses),
                                           reader=_reader())
        return losses

    assert run(False) == run(True)


def test_prefetcher_surfaces_reader_errors():
    def bad_reader():
        yield from _reader(n_batches=2)()
        raise RuntimeError("reader exploded")

    with pytest.raises(RuntimeError, match="reader exploded"):
        _trainer(prefetch=True).train(num_epochs=1, reader=bad_reader)


@pytest.mark.parametrize("kwargs, match", [
    ({"resilience": ResilienceConfig(elastic=True)}, "elastic"),
    ({"observability": ObservabilityConfig()}, None),
    ({"watch": WatchConfig(enabled=True)}, None),
], ids=["elastic", "observability", "watch"])
def test_not_ported_options_raise(kwargs, match):
    """Every option is ported: the telemetry options train; elastic
    training (``test_torch_elastic.py``) keeps the JAX package's guard, so
    a Trainer without ``parallel=True`` refuses it when it starts."""
    if match is None:
        trainer = _trainer(**kwargs)
        trainer.train(num_epochs=1, reader=_reader(n_batches=2))
        trainer.stop()
        assert trainer.global_step == 2
        return
    with pytest.raises(EnforceError, match=f"{match}.*parallel=True"):
        _trainer(**kwargs).train(num_epochs=1, reader=_reader(n_batches=2))


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_linreg_model, _sgd)


def test_executor_prepare_run_fetch_and_put():
    exe = Executor("cpu", max_cache=2)
    misses = prof.counters().get("executor.cache_misses_total", 0)

    def f(x):
        return {"y": x * 2, "n": x.sum()}

    g, h = (lambda x: x), (lambda x: x)
    prepared = exe.prepare(f)  # f, instrumented (compile and ledger hooks)
    assert exe.prepare(f) is prepared and prepared._fn is f
    exe.prepare(g)
    exe.prepare(f)  # a hit refreshes f, so h evicts g
    exe.prepare(h)
    assert list(exe._cache) == [f, h]
    assert prof.counters()["executor.cache_misses_total"] == misses + 3
    fed = exe.put((np.arange(4, dtype=np.int32), np.ones(2, np.float32)))
    assert fed[0].dtype == torch.int32 and fed[0].device.type == "cpu"
    out = exe.run(f, fed[1], fetch=True)
    assert isinstance(out["y"], np.ndarray) and float(out["n"]) == 2.0
    set_flags(check_nan_inf=True)
    try:
        with pytest.raises(EnforceError, match="NaN/Inf"):
            exe.run(f, torch.tensor([np.inf]), fetch=True)
    finally:
        set_flags(check_nan_inf=False)


# ---- tests/test_resilience.py, Trainer cases -------------------------------


def test_trainer_skip_step_policy_drops_bad_updates():
    metrics = []
    trainer = _trainer(resilience=ResilienceConfig(nan_policy="skip_step"))
    with faults.injected(faults.FaultSpec(faults.TRAINER_STEP, "nan", after=2, times=2)):
        trainer.train(num_epochs=1, reader=_reader(n_batches=6), event_handler=_losses(metrics))
    assert trainer.bad_steps == 2
    assert trainer.global_step == 4  # bad steps never advanced the counter
    assert sum(1 for m in metrics if not np.isfinite(m)) == 2
    assert bool(torch.isfinite(trainer.variables.params["fc/w"]).all())


def test_trainer_default_policy_still_raises():
    trainer = _trainer()
    with faults.injected(faults.FaultSpec(faults.TRAINER_STEP, "nan")):
        with pytest.raises(EnforceError, match="check_nan_inf"):
            trainer.train(num_epochs=1, reader=_reader())


def test_trainer_rollback_restores_last_good_checkpoint(tmp_path):
    trainer = _trainer(
        checkpoint_config=CheckpointConfig(str(tmp_path / "ckpt"), step_interval=1,
                                           max_num_checkpoints=8),
        resilience=ResilienceConfig(nan_policy="rollback", rollback_after=2, max_rollbacks=2),
    )
    # steps 2+3 go bad → rollback_after=2 restores the step-2 checkpoint
    with faults.injected(faults.FaultSpec(faults.TRAINER_STEP, "nan", after=2, times=2)):
        trainer.train(num_epochs=1, reader=_reader(n_batches=6))
    assert trainer.bad_steps == 2 and trainer.rollbacks == 1
    assert trainer.global_step == 4  # 2 good + rollback to 2 + 2 more good
    assert bool(torch.isfinite(trainer.variables.params["fc/w"]).all())


def test_trainer_rollback_gives_up_after_max_rollbacks(tmp_path):
    trainer = _trainer(
        checkpoint_config=CheckpointConfig(str(tmp_path / "ckpt"), step_interval=1),
        resilience=ResilienceConfig(nan_policy="rollback", rollback_after=1, max_rollbacks=1),
    )
    with faults.injected(faults.FaultSpec(faults.TRAINER_STEP, "nan", after=1, times=1000)):
        with pytest.raises(EnforceError, match="giving up"):
            trainer.train(num_epochs=1, reader=_reader(n_batches=6))
    assert trainer.rollbacks == 1


def test_trainer_step_watchdog_flags_stall():
    trainer = _trainer(resilience=ResilienceConfig(stall_timeout_s=0.05))
    with faults.injected(
        faults.FaultSpec(faults.TRAINER_STEP, "stall", after=1, times=1, stall_s=0.4)
    ):
        trainer.train(num_epochs=1, reader=_reader(n_batches=3))
    assert trainer._watchdog is None  # closed in train()'s finally


def test_resilience_config_validation_and_flags():
    with pytest.raises(EnforceError):
        ResilienceConfig(nan_policy="explode")
    with pytest.raises(EnforceError):
        ResilienceConfig(rollback_after=0)
    set_flags(check_nan_inf_policy="skip_step", nan_rollback_after=5)
    try:
        res = ResilienceConfig.from_flags()
        assert res.nan_policy == "skip_step" and res.rollback_after == 5
    finally:
        set_flags(check_nan_inf_policy="raise", nan_rollback_after=3)


def test_preemption_save_resume_with_flaky_checkpoint_io(tmp_path):
    """SIGTERM mid-epoch + the emergency checkpoint write failing ONCE: the
    save retries, the trainer exits preempted, and a fresh trainer resumes
    at the exact step with identical params."""
    root = str(tmp_path / "ckpt")
    trainer = _trainer(checkpoint_config=CheckpointConfig(root, step_interval=10_000))
    with faults.injected(
        faults.FaultSpec(faults.TRAINER_STEP, "preempt", after=2, times=1),
        faults.FaultSpec(faults.CHECKPOINT_SAVE, "error", times=1),
    ) as plan:
        trainer.train(num_epochs=2, reader=_reader(n_batches=6))
        assert plan.all_fired(), plan.stats()
    assert trainer.preempted
    assert 0 < trainer.global_step < 12
    saved_step = trainer.global_step
    saved_w = trainer.variables.params["fc/w"].clone()

    loaded, meta = ckpt_mod.load_checkpoint(root, (trainer.variables, trainer.opt_state))
    assert meta["step"] == saved_step
    assert torch.equal(saved_w, loaded[0].params["fc/w"])

    resumed = _trainer(checkpoint_config=CheckpointConfig(root, step_interval=10_000))
    steps = []
    resumed.train(num_epochs=2, reader=_reader(n_batches=6),
                  event_handler=lambda ev: steps.append(ev.step)
                  if isinstance(ev, EndStepEvent) else None)
    assert not resumed.preempted
    assert resumed.global_step == saved_step + len(steps)
    assert len(steps) == 12  # the interrupted epoch restarts, then epoch 1


# ---- the port's Trainer against the JAX package's --------------------------


def _jax_trainer(opt_name, lr, model=_jax_linreg_model, **kw):
    return jtrainer.Trainer(model, lambda: getattr(jpt.optimizer, opt_name)(learning_rate=lr), **kw)


def _carry(jt, tt, first_batch):
    """Initialize the JAX trainer and give the port's the same state."""
    jt._ensure_initialized(first_batch)
    tt.variables, tt.opt_state = convert.train_state_from_jax((jt.variables, jt.opt_state), "cpu")


def _compare_states(t_state, j_state, atol):
    t_leaves = convert.train_state_leaves(t_state)
    j_leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(j_state)]
    assert len(t_leaves) == len(j_leaves)
    for i, (a, b) in enumerate(zip(t_leaves, j_leaves)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("opt_name, lr", [("SGD", 0.1), ("Adam", 0.05)])
def test_trainer_matches_jax_trainer_linreg(opt_name, lr):
    jt = _jax_trainer(opt_name, lr)
    tt = Trainer(_linreg_model, lambda: getattr(pt.optimizer, opt_name)(learning_rate=lr),
                 place="cpu")
    _carry(jt, tt, next(iter(_reader()())))
    jl, tl = [], []
    jt.train(num_epochs=3, reader=_reader(),
             event_handler=lambda ev: jl.append(ev.metrics)
             if isinstance(ev, jtrainer.EndStepEvent) else None)
    tt.train(num_epochs=3, reader=_reader(), event_handler=_losses(tl))
    assert len(tl) == len(jl) == 12
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _compare_states((tt.variables, tt.opt_state), (jt.variables, jt.opt_state), atol=1e-5)
    assert tt.global_step == jt.global_step and tt.epoch == jt.epoch


SMALL_LM = dict(seq_len=64, vocab=512, d_model=64, d_inner=128, num_heads=4, n_layers=2)


@pytest.fixture
def lm_flags():
    names = ("use_flash_attention", "use_bf16_compute", "check_nan_inf")
    saved_j = {f: getattr(jconfig.flags(), f) for f in names}
    saved_t = {f: getattr(tconfig.flags(), f) for f in names}
    yield lambda **kw: (jconfig.set_flags(**kw), tconfig.set_flags(**kw))
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_trainer_matches_jax_trainer_lm(lm_flags, flash):
    """Three Trainer steps of the small LM (Adam, check_nan_inf on) in both
    packages from the JAX init's weights, on one fixed batch."""
    lm_flags(use_flash_attention=flash, use_bf16_compute=False, check_nan_inf=True)
    jspec = jmodels.get_model("transformer_lm", **SMALL_LM)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **SMALL_LM)
    batches = [tuple(np.asarray(a) for a in jspec.synth_batch(2, np.random.RandomState(0)))] * 3
    jt = jtrainer.Trainer(lambda: jspec.model, jspec.optimizer)
    tt = Trainer(lambda: tspec.model, tspec.optimizer, place="cpu")
    _carry(jt, tt, batches[0])
    jl, tl = [], []
    jt.train(num_epochs=1, reader=lambda: iter(batches),
             event_handler=lambda ev: jl.append(ev.metrics)
             if isinstance(ev, jtrainer.EndStepEvent) else None)
    tt.train(num_epochs=1, reader=lambda: iter(batches), event_handler=_losses(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    lr = tspec.extra["learning_rate"]
    tparams = convert.params_to_numpy(tt.variables.params)
    for n, a in jt.variables.params.items():
        atol = 3 * lr if n.endswith("self_attn/k/b") else 1e-4
        np.testing.assert_allclose(tparams[n], np.asarray(a), rtol=0, atol=atol, err_msg=n)
    tstate = convert.opt_state_to_numpy(tt.opt_state)
    assert tstate["step"] == int(jt.opt_state.step) == 3
    for s, d in jt.opt_state.slots.items():
        for n, a in d.items():
            if not n.endswith("self_attn/k/b"):
                np.testing.assert_allclose(tstate["slots"][s][n], np.asarray(a), rtol=1e-4,
                                           atol=1e-7, err_msg=f"{s}/{n}")
