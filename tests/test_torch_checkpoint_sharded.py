"""The port's sharded checkpoints (``paddle_tpu_torch.checkpoint_sharded``)
on the CPU: every case of ``tests/test_checkpoint_sharded.py:26-350``
ported (one process, or two gloo ranks where the JAX test shards over a
mesh), integrity fallback and the in-memory snapshot, and the format
across the packages: a JAX ``save_sharded`` of a ``DataParallel(data=2)``
training state with ZeRO-1 loads in the port at one and two ranks, and
the port's two-rank ZeRO-1 save loads in the JAX package, parameters and
Adam slots bit-equal (a checkpoint moves numbers, it never rounds them).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_parallel_cases as cases
from paddle_tpu import checkpoint_sharded as jcks
from paddle_tpu import models as jmodels
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.observability.runlog import RunLog, read_runlog, set_runlog
from paddle_tpu_torch.optimizer import OptState
from paddle_tpu_torch.parallel import DataParallel, launch
from paddle_tpu_torch.parallel.sharding import LeafLayout
from paddle_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _drained():
    yield
    faults.clear()
    try:
        cks.wait_pending_save(timeout=60)
    except OSError:
        pass


def _tree(rng):
    return {"w": torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
            "nested": {"r": torch.from_numpy(rng.randn(6, 4).astype(np.float32)),
                       "b": torch.from_numpy(rng.randn(5).astype(np.float32))}}


def _equal(a, b):
    la, lb = tree_mod.leaves(a), tree_mod.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# ---- one process --------------------------------------------------------------
def test_roundtrip_bit_exact(tmp_path, rng):
    tree = _tree(rng)
    path = cks.save_sharded(str(tmp_path), tree, step=7, extra_meta={"tag": "x"})
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert os.path.exists(os.path.join(path, "shards_p0.npz.crc"))
    restored, manifest = cks.load_sharded(str(tmp_path), tree)
    assert manifest["step"] == 7 and manifest["tag"] == "x"
    assert manifest["num_processes"] == 1 and manifest["num_leaves"] == 3
    _equal(tree, restored)


def test_latest_and_prune(tmp_path, rng):
    t = {"p": torch.from_numpy(rng.randn(8).astype(np.float32))}
    for s in (1, 2, 3, 4):
        cks.save_sharded(str(tmp_path), t, step=s, max_num_checkpoints=2)
    assert cks.latest_sharded_checkpoint(str(tmp_path)).endswith("checkpoint_4")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3", "checkpoint_4"]


def test_corrupt_manifest_refused(tmp_path, rng):
    t = {"p": torch.from_numpy(rng.randn(8).astype(np.float32))}
    cks.save_sharded(str(tmp_path), t, step=1)
    with pytest.raises(EnforceError, match="target has 2"):
        cks.load_sharded(str(tmp_path), {"p": t["p"], "q": t["p"]})
    with pytest.raises(EnforceError, match="shape"):
        cks.load_sharded(str(tmp_path), {"p": torch.zeros(4)})


def test_corrupt_serial_quarantined_and_previous_loaded(tmp_path, rng):
    t1 = {"p": torch.from_numpy(rng.randn(8).astype(np.float32))}
    t2 = {"p": t1["p"] * 2}
    cks.save_sharded(str(tmp_path), t1, step=1)
    path = cks.save_sharded(str(tmp_path), t2, step=2)
    with open(os.path.join(path, "shards_p0.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\x00\xff" * 8)
    restored, manifest = cks.load_sharded(str(tmp_path), t1)
    assert manifest["step"] == 1 and torch.equal(restored["p"], t1["p"])
    assert any(n.startswith("checkpoint_2") and "corrupt" in n for n in os.listdir(tmp_path))


def test_bf16_leaves_refused(tmp_path):
    with pytest.raises(EnforceError, match="bfloat16"):
        cks.save_sharded(str(tmp_path), {"p": torch.zeros(4, dtype=torch.bfloat16)}, step=1)


def test_trainstate_roundtrip_through_optimizer(tmp_path, rng):
    """The full train state (params + Adam slots + step) round-trips and the
    restored state continues training identically."""
    model = pt.build(cases.mlp_net(pt.layers, pt.ops, torch.mean), name="mlp")
    x, y = rng.randn(16, 3).astype(np.float32), rng.randn(16).astype(np.float32)
    dp = DataParallel(model, pt.optimizer.Adam(1e-2), device="cpu")
    v, o = dp.init(0, x, y)
    out = dp.step(v, o, *dp.put_batch(x, y))
    v, o = out.variables, out.opt_state
    cks.save_sharded(str(tmp_path), {"v": v, "o": o}, step=1, template={
        "v": dp.state_template(v, o)[0], "o": dp.state_template(v, o)[1]})
    restored, _ = cks.load_sharded(str(tmp_path), {"v": v, "o": o})
    _equal({"v": v, "o": o}, restored)
    out1 = dp.step(v, o, *dp.put_batch(x, y))
    out2 = dp.step(restored["v"], restored["o"], *dp.put_batch(x, y))
    assert float(out1.loss) == float(out2.loss)


def test_trainer_sharded_checkpoint_resume(tmp_path):
    """Trainer(parallel=True) with CheckpointConfig(sharded=True): save
    during training, then a fresh Trainer auto-resumes from the sharded
    layout."""
    from paddle_tpu_torch.trainer import CheckpointConfig, Trainer

    cfg = CheckpointConfig(str(tmp_path / "ck"), step_interval=2, sharded=True)
    reader = cases.linreg_reader(n_batches=4, bs=16)

    def make():
        return Trainer(cases._linreg, lambda: pt.optimizer.Adam(1e-2), place="cpu",
                       checkpoint_config=cfg, parallel=True)

    t1 = make()
    t1.train(num_epochs=1, reader=reader)
    assert t1.global_step == 4
    t2 = make()
    t2.train(num_epochs=1, reader=reader)  # resumes at epoch 1: no new steps
    assert t2.global_step == 4
    _equal(t1.variables.params, t2.variables.params)
    _equal(t1.opt_state, t2.opt_state)


def test_async_save_round_trip(tmp_path):
    """save_sharded_async: the snapshot is taken at the call (a later
    in-place write does not reach the file), then a background write
    publishes the same restorable checkpoint; back-to-back saves keep
    their order."""
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    tree = {"w": x.clone(), "step_scalar": torch.tensor(3.0)}
    h1 = cks.save_sharded_async(str(tmp_path), tree, step=1)
    tree["w"].mul_(100.0)  # after the snapshot: must not reach checkpoint_1
    h2 = cks.save_sharded_async(str(tmp_path), {"w": x * 2, "step_scalar": torch.tensor(4.0)},
                                step=2)
    d2 = h2.result(timeout=60)
    assert h1.done and h2.done and d2.endswith("checkpoint_2")
    assert cks.wait_pending_save(timeout=60) == d2
    assert cks.wait_pending_save() is None  # idempotent once drained
    like = {"w": torch.zeros(8, 4), "step_scalar": torch.tensor(0.0)}
    restored, manifest = cks.load_sharded(str(tmp_path), like)
    assert torch.equal(restored["w"], x * 2) and manifest["step"] == 2
    assert restored["step_scalar"].shape == () and float(restored["step_scalar"]) == 4.0
    first, _ = cks.load_sharded(h1.result(), like)
    assert torch.equal(first["w"], x)


def _one_tree():
    return {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}


def test_wait_pending_save_timeout_keeps_pending(tmp_path):
    with faults.injected(faults.FaultSpec(faults.CHECKPOINT_SAVE, "stall", stall_s=1.0, times=1)):
        cks.save_sharded_async(str(tmp_path), _one_tree(), step=1)
        with pytest.raises(EnforceError, match="timed out"):
            cks.wait_pending_save(timeout=0.05)
        path = cks.wait_pending_save(timeout=60)
    assert path.endswith("checkpoint_1")
    assert cks.wait_pending_save() is None


def test_wait_pending_save_raises_writer_error_once(tmp_path):
    # times=3 outlasts retry_call's 3 attempts inside the writer thread
    with faults.injected(faults.FaultSpec(faults.CHECKPOINT_SAVE, "error", times=3)):
        h = cks.save_sharded_async(str(tmp_path), _one_tree(), step=1)
        with pytest.raises(OSError):
            h.result(timeout=60)
        with pytest.raises(OSError):
            cks.wait_pending_save(timeout=60)
    assert cks.wait_pending_save() is None  # cleared after raising


def test_failed_async_save_alerts_and_next_save_proceeds(tmp_path):
    runlog_path = str(tmp_path / "runlog.jsonl")
    prev = set_runlog(RunLog(runlog_path))
    try:
        with faults.injected(faults.FaultSpec(faults.CHECKPOINT_SAVE, "error", times=3)):
            h1 = cks.save_sharded_async(str(tmp_path / "ckpt"), _one_tree(), step=1)
            with pytest.raises(OSError):
                h1.result(timeout=60)
        before = prof.counters().get("checkpoint.async_errors_total", 0)
        tree2 = {"w": _one_tree()["w"] * 2}
        h2 = cks.save_sharded_async(str(tmp_path / "ckpt"), tree2, step=2)
        assert h2.result(timeout=60).endswith("checkpoint_2")
        assert prof.counters()["checkpoint.async_errors_total"] == before + 1
        alerts = [e for e in read_runlog(runlog_path)
                  if e["kind"] == "alert" and e.get("key") == "async_save_failed"]
        assert len(alerts) == 1 and alerts[0]["source"] == "checkpoint"
        assert cks.wait_pending_save(timeout=60).endswith("checkpoint_2")
        restored, manifest = cks.load_sharded(str(tmp_path / "ckpt"), {"w": torch.zeros(8, 4)})
        assert manifest["step"] == 2 and torch.equal(restored["w"], tree2["w"])
    finally:
        set_runlog(prev)


def test_async_write_telemetry(tmp_path):
    runlog_path = str(tmp_path / "runlog.jsonl")
    prev = set_runlog(RunLog(runlog_path))
    try:
        count0 = prof.histograms().get("checkpoint.async_write_seconds", {}).get("count", 0)
        path = cks.save_sharded_async(str(tmp_path / "ckpt"), _one_tree(), step=5).result(60)
        assert prof.histograms()["checkpoint.async_write_seconds"]["count"] == count0 + 1
        writes = [e for e in read_runlog(runlog_path) if e["kind"] == "checkpoint_async_write"]
        assert len(writes) == 1
        assert writes[0]["step"] == 5 and writes[0]["path"] == path and writes[0]["seconds"] >= 0
    finally:
        set_runlog(prev)


def test_snapshot_listener_and_restore_from_snapshot(tmp_path, rng):
    seen = []
    cks.set_snapshot_listener(lambda data, manifest: seen.append((data, manifest)))
    try:
        tree = _tree(rng)
        cks.save_sharded_async(str(tmp_path), tree, step=3).result(60)
    finally:
        cks.set_snapshot_listener(None)
    assert len(seen) == 1
    data, manifest = seen[0]
    target = {"w": LeafLayout((8, 4), torch.float32, "cpu", [(4, 8), (0, 4)]),
              "nested": {"r": torch.zeros(6, 4), "b": torch.zeros(5)}}
    restored, m = cks.restore_from_snapshot(data, manifest, target)
    assert m["step"] == 3
    assert torch.equal(restored["w"], tree["w"][4:])
    assert torch.equal(restored["nested"]["r"], tree["nested"]["r"])


# ---- two ranks ----------------------------------------------------------------
def test_two_rank_save_dedups_and_restores_resharded(tmp_path):
    """Saved at 2 ranks by rows (each rank one file), then restored at 2
    ranks by columns and at 1 rank whole: the blocks assemble bit-exact
    (the JAX test's cross-mesh restore). A replicated leaf is written once."""
    r = np.random.RandomState(7)
    truth = {"w2d": r.randn(16, 8).astype(np.float32), "w1d": r.randn(32).astype(np.float32),
             "scalar": np.asarray(r.randn(), np.float32)}
    root = str(tmp_path / "ck")
    paths = launch.spawn(cases.windows_save, 2, args=(root, truth), device="cpu")
    assert paths[0] == paths[1]
    with np.load(os.path.join(paths[0], "shards_p0.npz")) as z0, \
            np.load(os.path.join(paths[0], "shards_p1.npz")) as z1:
        assert sorted(z0.files) == ["leaf_0|", "leaf_1|0:16", "leaf_2|0:8,0:8"]
        assert sorted(z1.files) == ["leaf_1|16:32", "leaf_2|8:16,0:8"]
    manifest = json.load(open(os.path.join(paths[0], "manifest.json")))
    assert manifest["num_processes"] == 2
    shapes = {k: v.shape for k, v in truth.items()}
    halves = launch.spawn(cases.windows_load, 2, args=(root, shapes, 1), device="cpu")
    np.testing.assert_array_equal(np.concatenate([h["w2d"] for h in halves], 1), truth["w2d"])
    np.testing.assert_array_equal(halves[1]["w1d"], truth["w1d"])  # 1-d: whole on both
    whole, _ = cks.load_sharded(root, {k: torch.zeros(s) for k, s in shapes.items()})
    for k, v in truth.items():
        np.testing.assert_array_equal(whole[k].numpy(), v)


def _lm_case():
    spec = jmodels.get_model("transformer_lm", **cases.LM)
    batch = tuple(np.asarray(b) for b in spec.synth_batch(4, np.random.RandomState(5)))
    jvars = spec.model.init(jax.random.PRNGKey(0), *batch)
    return spec, batch, {k: np.asarray(a) for k, a in jvars.params.items()}


def _port_lm_template(params):
    model, opt = cases.port_model("lm")
    v = Variables(cases.tensors(params), {})
    return v, opt().create_state(v.params)


def test_jax_zero1_checkpoint_loads_in_the_port_at_1_and_2_ranks(tmp_path):
    spec, batch, params = _lm_case()
    dp = JDataParallel(spec.model, spec.optimizer(), zero_shard_optimizer=True, donate=False,
                       mesh=jmake_mesh(data=2, devices=jax.devices()[:2]))
    v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
        {k: jnp.asarray(a) for k, a in params.items()}, {}))
    for _ in range(2):
        out = dp.step(v, o, *batch)
        v, o = out.variables, out.opt_state
    root = str(tmp_path / "jax")
    jcks.save_sharded(root, (v, o), step=2)
    want_p = {k: np.asarray(a) for k, a in v.params.items()}
    want_s = {s: {k: np.asarray(a) for k, a in d.items()} for s, d in o.slots.items()}
    # one rank, whole leaves
    (tv, to), manifest = cks.load_sharded(root, _port_lm_template(params))
    assert manifest["step"] == 2 and to.step == 2
    for k, a in want_p.items():
        np.testing.assert_array_equal(tv.params[k].numpy(), a)
    for s, d in want_s.items():
        for k, a in d.items():
            np.testing.assert_array_equal(to.slots[s][k].numpy(), a)
    # two ranks with ZeRO-1: each rank's rows
    ranks = launch.spawn(cases.load_zero_lm, 2, args=(root, batch, params, True), device="cpu")
    for r, (state, step, mstep) in enumerate(ranks):
        assert step == mstep == 2
        for k, a in want_p.items():
            np.testing.assert_array_equal(state[0][k], a)
        for s, d in want_s.items():
            for k, a in d.items():
                rows = state[2][s][k]
                dim = next(i for i, (m, n) in enumerate(zip(rows.shape, a.shape)) if m != n) \
                    if rows.shape != a.shape else None
                if dim is None:
                    np.testing.assert_array_equal(rows, a)
                else:
                    h = rows.shape[dim]
                    np.testing.assert_array_equal(rows, np.take(a, range(r * h, (r + 1) * h), dim))


def test_port_zero1_checkpoint_loads_in_jax(tmp_path):
    spec, batch, params = _lm_case()
    root = str(tmp_path / "port")
    ranks = launch.spawn(cases.save_zero_lm, 2, args=(root, batch, params, True), device="cpu")
    path = cks.latest_sharded_checkpoint(root)
    assert sorted(f for f in os.listdir(path) if f.endswith(".npz")) == [
        "shards_p0.npz", "shards_p1.npz"]
    # the port's whole state, from its two ranks' rows
    full_p, _, rows0 = ranks[0]
    rows1 = ranks[1][2]

    def whole(s, k):
        a, b = rows0[s][k], rows1[s][k]
        if a.shape == full_p[k].shape:
            np.testing.assert_array_equal(a, b)
            return a
        dim = next(i for i, (m, n) in enumerate(zip(a.shape, full_p[k].shape)) if m != n)
        return np.concatenate([a, b], dim)

    # JAX: into its own DP(2) ZeRO-1 layout and into a plain single-device tree
    dp = JDataParallel(spec.model, spec.optimizer(), zero_shard_optimizer=True, donate=False,
                       mesh=jmake_mesh(data=2, devices=jax.devices()[:2]))
    v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
        {k: jnp.asarray(a) for k, a in params.items()}, {}))
    for target in ((v, o), dp.state_template(v, o)):
        (jv, jo), manifest = jcks.load_sharded(root, target)
        assert manifest["step"] == 2 and int(jo.step) == 2
        for k, a in full_p.items():
            np.testing.assert_array_equal(np.asarray(jv.params[k]), a)
        for s, d in jo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(np.asarray(a), whole(s, k))


def test_port_one_rank_checkpoint_loads_in_jax(tmp_path):
    """The port's single-rank sharded save (a Trainer-shaped (Variables,
    OptState) tree) restores in the JAX package bit-equal."""
    spec, batch, params = _lm_case()
    tv, to = _port_lm_template(params)
    to = OptState(step=5, slots={s: {k: t + 0.25 for k, t in d.items()}
                                 for s, d in to.slots.items()})
    cks.save_sharded(str(tmp_path), (tv, to), step=5)
    jv = JVariables({k: jnp.asarray(a) for k, a in params.items()}, {})
    jo = spec.optimizer().create_state(jv.params)
    (rv, ro), _ = jcks.load_sharded(str(tmp_path), (jv, jo))
    assert int(ro.step) == 5
    for k in params:
        np.testing.assert_array_equal(np.asarray(rv.params[k]), tv.params[k].numpy())
        for s in ro.slots:
            np.testing.assert_array_equal(np.asarray(ro.slots[s][k]), to.slots[s][k].numpy())
