"""The port's ``Trainer(parallel=True)`` on the CPU, against the JAX
package's ``Trainer(parallel=True)`` at ``make_mesh(data=2)`` on the same
weights (a constant initializer in both packages) and the same reader: the
parallel path (``tests/test_trainer.py:101``), ragged training through
``allow_ragged`` (``tests/test_parallel_extensions.py:1025,1078``), exact
evaluation over a ragged test set (``:933,980``), the async-save drain on
an exception exit (``tests/test_trainer.py:269,296``), and resume from
sharded and single-file checkpoints — across world sizes and with ZeRO-1.

Two-rank runs are spawned gloo groups (``torch_parallel_cases.py``).
Tolerances: per-step losses at rtol 1e-5 and parameters at atol 1e-5
against the JAX package (``tests/test_torch_trainer.py``'s, for the same
linear regression); a resumed run against the uninterrupted one at the
same world size bit for bit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
import torch_parallel_cases as cases
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.trainer import EndStepEvent as JEndStepEvent, Trainer as JTrainer
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.parallel import launch
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.trainer import CheckpointConfig, Trainer

_jax_linreg = cases.linreg_net(jpt, jnp.mean)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear()
    try:
        cks.wait_pending_save(timeout=60)
    except OSError:
        pass


def _jax_run(epochs=2, n_batches=4, tail=0, allow_ragged=False):
    t = JTrainer(_jax_linreg, lambda: jpt.optimizer.SGD(learning_rate=0.1), parallel=True,
                 parallel_kwargs=dict(mesh=jmake_mesh(data=2, devices=jax.devices()[:2]),
                                      donate=False))
    losses = []
    t.train(num_epochs=epochs, reader=cases.linreg_reader(n_batches=n_batches, tail=tail),
            allow_ragged=allow_ragged,
            event_handler=lambda ev: losses.append(ev.metrics)
            if isinstance(ev, JEndStepEvent) else None)
    return losses, {k: np.asarray(a) for k, a in t.variables.params.items()}


def _same_on_both(ranks, slots=True):
    """Both ranks' losses, parameters and state bit-equal (and their slots,
    which ZeRO-1 splits between them)."""
    assert ranks[0]["losses"] == ranks[1]["losses"]
    (p0, s0, o0), (p1, s1, o1) = ranks[0]["state"], ranks[1]["state"]
    for a, b in ((p0, p1), (s0, s1)) + (tuple(zip(o0.values(), o1.values())) if slots else ()):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _close_to_jax(got, want_losses, want_params):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    for k, a in want_params.items():
        np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tail, prefetch", [(0, False), (5, False), (5, True)],
                         ids=["divisible", "allow_ragged", "allow_ragged_prefetch"])
def test_parallel_trainer_matches_jax(tail, prefetch):
    """Two ranks over the same reader: the losses fall, every rank holds
    the same state, and both equal the JAX package's parallel Trainer —
    with a ragged 5-row tail batch trained through ``step_ragged``."""
    kw = dict(epochs=2, tail=tail, allow_ragged=bool(tail), prefetch=prefetch)
    ranks = launch.spawn(cases.trainer_run, 2, args=(None, "train", kw), device="cpu")
    _same_on_both(ranks)
    got = ranks[0]
    assert got["devices"] == 2 and got["step"] == 2 * (4 + (1 if tail else 0))
    assert got["losses"][-1] < got["losses"][0]
    _close_to_jax(got, *_jax_run(epochs=2, tail=tail, allow_ragged=bool(tail)))


def test_evaluate_exact_over_ragged_test_set():
    """29 rows (3 x 8 + a ragged 5) over 2 ranks: every row counts once,
    so the metric equals a direct computation over all rows."""
    ranks = launch.spawn(cases.trainer_run, 2, args=(None, "evaluate", {}), device="cpu")
    assert ranks[0]["metric"] == ranks[1]["metric"]
    params = ranks[0]["state"][0]
    xs, ys = (np.concatenate(a) for a in zip(*cases.linreg_reader(n_batches=3, bs=8, tail=5)()))
    w = next(v for k, v in params.items() if v.ndim == 2)
    b = next(v for k, v in params.items() if v.ndim == 1)
    want = float(np.mean((xs @ w + b)[:, 0] > ys[:, 0]))
    assert ranks[0]["metric"] == pytest.approx(want, abs=1e-12)


def _cpu_trainer(root=None, **kw):
    cfg = None if root is None else CheckpointConfig(root, step_interval=2, **kw)
    return Trainer(cases._linreg, lambda: pt.optimizer.SGD(learning_rate=0.1), place="cpu",
                   parallel=True, checkpoint_config=cfg)


def test_evaluate_rejects_column_metric_and_handles_ragged_first():
    t = _cpu_trainer()
    t.train(num_epochs=1, reader=cases.linreg_reader(n_batches=1, bs=16))

    def ragged_first():
        yield from cases.linreg_reader(n_batches=0, tail=4)()
        yield from cases.linreg_reader(n_batches=1, bs=16, seed=1)()

    with pytest.raises(EnforceError, match="one value per row"):
        t.evaluate(ragged_first, lambda out, x, y: out[1].numpy() > np.asarray(y))
    got = t.evaluate(ragged_first, lambda out, x, y: (out[1][:, 0].numpy() > np.asarray(y)[:, 0]))
    assert 0.0 <= got <= 1.0


def _bad_reader():
    for i, batch in enumerate(cases.linreg_reader(n_batches=8)()):
        if i == 3:  # steps 1..3 ran; the step-2 async save is queued
            raise RuntimeError("reader exploded")
        yield batch


def test_train_exception_exit_drains_async_save(tmp_path):
    root = str(tmp_path / "ckpt")
    t = _cpu_trainer(root, sharded=True, async_save=True)
    with pytest.raises(RuntimeError, match="reader exploded"):
        t.train(num_epochs=1, reader=_bad_reader)
    assert cks.wait_pending_save() is None  # the finally-block drain joined it
    assert cks.latest_sharded_checkpoint(root).endswith("checkpoint_2")


def test_train_exception_exit_writer_failure_does_not_mask_error(tmp_path):
    root = str(tmp_path / "ckpt")
    t = _cpu_trainer(root, sharded=True, async_save=True)
    # times=3 outlasts the writer's 3 attempts: the step-2 save fails
    with faults.injected(faults.FaultSpec(faults.CHECKPOINT_SAVE, "error", times=3)):
        with pytest.raises(RuntimeError, match="reader exploded"):
            t.train(num_epochs=1, reader=_bad_reader)
    assert cks.wait_pending_save() is None  # drained (failure logged)
    assert cks.latest_sharded_checkpoint(root) is None  # nothing published


@pytest.mark.parametrize("sharded, zero", [(True, False), (True, True), (False, True)],
                         ids=["sharded", "sharded_zero1", "single_file_zero1"])
def test_two_rank_resume_equals_uninterrupted(tmp_path, sharded, zero):
    """Epoch 0 at two ranks with a checkpoint every 2 steps, then fresh
    Trainers at two ranks resume and run epoch 1: bit-equal to two
    uninterrupted epochs (Adam, so the slots matter; ZeRO-1 saves each
    rank's rows, or gathers them for the single-file layout)."""
    kw = dict(adam=True, sharded=sharded, parallel_kwargs=dict(zero_shard_optimizer=zero))
    root = str(tmp_path / "ckpt")
    first = launch.spawn(cases.trainer_run, 2, args=(root, "train", dict(kw, epochs=1)),
                         device="cpu")
    assert first[0]["step"] == 4
    if sharded:
        names = sorted(os.listdir(cks.latest_sharded_checkpoint(root)))
        assert "shards_p1.npz" in names and "manifest.json" in names
    resumed = launch.spawn(cases.trainer_run, 2, args=(root, "train", dict(kw, epochs=2)),
                           device="cpu")
    whole = launch.spawn(cases.trainer_run, 2, args=(str(tmp_path / "w"), "train",
                                                     dict(kw, epochs=2)), device="cpu")
    _same_on_both(resumed, slots=not zero)
    assert resumed[0]["losses"] == whole[0]["losses"][4:]
    for got, want in zip(resumed[0]["state"], whole[0]["state"]):
        for k in want:
            if isinstance(want[k], dict):
                for kk in want[k]:
                    np.testing.assert_array_equal(got[k][kk], want[k][kk])
            else:
                np.testing.assert_array_equal(got[k], want[k])


def test_two_rank_zero1_checkpoint_resumes_at_one_rank(tmp_path):
    """A sharded checkpoint written by two ZeRO-1 ranks resumes in a
    one-rank Trainer (resharded restore): its state equals the two ranks'
    whole state."""
    root = str(tmp_path / "ckpt")
    kw = dict(adam=True, sharded=True, parallel_kwargs=dict(zero_shard_optimizer=True), epochs=1)
    ranks = launch.spawn(cases.trainer_run, 2, args=(root, "train", kw), device="cpu")
    t = Trainer(cases._linreg, lambda: pt.optimizer.Adam(0.05), place="cpu", parallel=True,
                checkpoint_config=CheckpointConfig(root, step_interval=2, sharded=True))
    t.train(num_epochs=1, reader=cases.linreg_reader())  # resumes past epoch 0: no step
    assert t.global_step == 4
    for k, a in ranks[0]["state"][0].items():
        np.testing.assert_array_equal(t.variables.params[k].numpy(), a)
    for s, d in t.opt_state.slots.items():
        for k, whole in d.items():
            rows = [ranks[r]["state"][2][s][k] for r in range(2)]
            if rows[0].shape == tuple(whole.shape):
                np.testing.assert_array_equal(whole.numpy(), rows[0])
            else:
                dim = next(i for i, (m, n) in enumerate(zip(rows[0].shape, whole.shape)) if m != n)
                np.testing.assert_array_equal(whole.numpy(), np.concatenate(rows, dim))
