"""Elastic training in the port (``paddle_tpu_torch.resilience.elastic``)
against the JAX package's supervisor: every case of
``tests/test_elastic.py`` ported, and a real death of the first and of the
last rank.

The JAX supervisor shrinks a mesh inside one process; the port runs one
process per rank, so its multi-rank cases are gloo ranks on the CPU spawned
by ``launch.spawn(device="cpu")`` (rank bodies in
``torch_elastic_cases.py``), five spawns in all, each shared by the tests
that read it (module fixtures). The model is the JAX test's linear
regression (reader seed 7, SGD 0.1, a sharded checkpoint every 2 steps)
with a constant initializer in both packages.

Tolerances: the shrink's losses from the restored step against the JAX
supervisor's on the 8-device CPU mesh (8 -> 7 devices; the port goes 4 ->
3, ragged as the JAX run is) at rtol 1e-5; against a cold restart of the
port on the same 3 ranks from the same checkpoint at rtol 1e-6 (the
global-batch loss does not depend on the world size, up to the rounding
of a mean over ranks); the real-death and regrow runs against the port's
one-process Trainer on the same batches at rtol 1e-6.

The port restores from disk with several ranks (saves there are
synchronous and call no snapshot listener), so ``last_recovery["source"]``
reads ``"disk"`` where the JAX single-process test reads ``"snapshot"``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
import torch_elastic_cases as cases
from paddle_tpu.resilience import ResilienceConfig as JResilienceConfig
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.trainer import CheckpointConfig as JCheckpointConfig
from paddle_tpu.trainer import EndStepEvent as JEndStepEvent
from paddle_tpu.trainer import Trainer as JTrainer
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.parallel import DataParallel, launch
from paddle_tpu_torch.parallel.mesh import make_mesh, remesh
from paddle_tpu_torch.parallel.sharding import LeafLayout
from paddle_tpu_torch.resilience import ResilienceConfig, faults
from paddle_tpu_torch.resilience.elastic import ElasticSupervisor, is_device_loss
from paddle_tpu_torch.resilience.faults import DeviceLostError
from paddle_tpu_torch.trainer import EndStepEvent, Trainer

# gloo's texts for a peer whose process ended (a survivor's pending
# collective raises one of these within tens of ms)
GLOO_CLOSED = ("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection closed by peer "
               "[127.0.0.1]:16017. This is typically caused by a remote worker crashing.")
GLOO_RESET = ("[../third_party/gloo/gloo/transport/tcp/pair.cc:537] Read error "
              "[127.0.0.1]:36016: Connection reset by peer.")
NCCL_ABORTED = "NCCL communicator was aborted on rank 1."
NCCL_WATCHDOG = ("[Rank 0] Watchdog caught collective operation timeout: "
                 "WorkNCCL(SeqNum=5, OpType=ALLREDUCE) ran for 60000 milliseconds")


@pytest.fixture(autouse=True)
def _clean():
    yield
    cks.set_snapshot_listener(None)
    faults.clear()
    try:
        cks.wait_pending_save(timeout=60)
    except OSError:
        pass


def _spawn(case, n, args, **kw):
    return launch.spawn(case, n, args=args, device="cpu", timeout_s=300,
                        collective_timeout_s=cases.COLLECTIVE_TIMEOUT_S, **kw)


def _port_reference(first_steps, batches, bs):
    """The port's one-process Trainer on the batches an elastic run trains
    after its restore: ``first_steps`` steps (the restored serial's), then
    the interrupted epoch again from its first batch."""
    t = Trainer(cases._linreg, cases._sgd, place="cpu")
    t.train(num_epochs=1, reader=cases.reader(n_batches=first_steps, bs=bs))
    losses = []
    t.train(num_epochs=1, reader=cases.reader(n_batches=batches, bs=bs),
            event_handler=lambda ev: losses.append(ev.metrics)
            if isinstance(ev, EndStepEvent) else None)
    return losses


def _jax_shrink(root, out):
    """The JAX test's elastic shrink (``test_elastic_shrink_matches_cold_
    restart``): the 8-device CPU mesh loses device 3 at step 5."""
    spec = jfaults.FaultSpec(
        jfaults.DEVICE_LOST, "error", after=5, times=1,
        exc=jfaults.DeviceLostError("injected device loss", device_indices=(3,)))
    losses = []
    with jfaults.injected(spec):
        t = JTrainer(cases.linreg_net(jpt, jnp.mean), lambda: jpt.optimizer.SGD(learning_rate=0.1),
                     parallel=True,
                     checkpoint_config=JCheckpointConfig(root, step_interval=2, sharded=True,
                                                         async_save=True),
                     resilience=JResilienceConfig(elastic=True))
        t.train(num_epochs=1, reader=cases.reader(),
                event_handler=lambda ev: losses.append(ev.metrics)
                if isinstance(ev, JEndStepEvent) else None)
        t.stop()
    out.update(losses=losses, devices=t._dp.num_devices, rec=t._elastic.last_recovery)


@pytest.fixture(scope="module")
def shrink_runs(tmp_path_factory):
    """One spawn of 4 ranks (``cases.shrink``), the JAX run meanwhile."""
    root = tmp_path_factory.mktemp("elastic_shrink")
    jax_out = {}
    jt = threading.Thread(target=_jax_shrink, args=(str(root / "jax"), jax_out))
    jt.start()
    try:
        ranks = _spawn(cases.shrink, 4, (str(root / "a"), str(root / "b"), str(root)),
                       may_leave=(3,))
    finally:
        jt.join()
    return ranks, jax_out


@pytest.fixture(scope="module")
def death_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_deaths")
    return _spawn(cases.real_deaths, 3, (str(root / "one"), str(root / "two")), may_leave=(0, 2))


@pytest.fixture(scope="module")
def regrow_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_regrow")
    return _spawn(cases.regrow_and_min, 3, (str(root / "ck"), str(root / "min"), str(root)),
                  may_leave=(2,), join=[(2, 2)])


@pytest.fixture(scope="module")
def one_rank_regrow_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_one_rank")
    return _spawn(cases.regrow_from_one_rank, 2, (str(root / "ck"),), may_leave=(1,),
                  join=[(1, 2)])


@pytest.fixture(scope="module")
def preempt_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_preempt")
    return _spawn(cases.preempt_and_stall, 3, (str(root / "p"), str(root / "s")),
                  may_leave=(2,))


# ---------------------------------------------------------------------------
# primitives: remesh / resize / state_template / restore_from_snapshot
# ---------------------------------------------------------------------------


def test_remesh_keeps_non_resized_axis_sizes():
    mesh = make_mesh(data=4, model=2, devices=list(range(8)))
    smaller = remesh(mesh, list(range(6)))
    assert smaller.axis_names == ("data", "model")
    assert smaller.shape == {"data": 3, "model": 2}
    np.testing.assert_array_equal(smaller.devices, np.arange(6).reshape(3, 2))
    # non-resized axes must still divide the rank count
    with pytest.raises(EnforceError):
        remesh(mesh, list(range(7)))


def test_dp_resize_drops_compiled_steps_and_restep():
    rng = np.random.RandomState(0)
    dp = DataParallel(pt.build(cases._linreg()), cases._sgd(), device="cpu")
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    variables, opt_state = dp.init(0, x, y)
    out = dp.step(variables, opt_state, x, y)
    assert dp._step_fn is not None and dp._layout is not None
    old_mesh = dp.mesh
    assert dp.resize([0]) is dp.mesh and dp.mesh is not old_mesh
    assert dp._step_fn is None and dp._ragged_fn is None and dp._layout is None
    assert dp.num_devices == 1 and dp._token_axes == ("data",)
    variables, opt_state = dp.place_state(out.variables, out.opt_state)
    out2 = dp.step(variables, opt_state, x, y)
    assert np.isfinite(float(out2.loss)) and float(out2.loss) < float(out.loss)


def test_state_template_matches_state_tree():
    rng = np.random.RandomState(0)
    dp = DataParallel(pt.build(cases._linreg()), cases._sgd(), device="cpu")
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    variables, opt_state = dp.init(0, x, y)
    var_t, opt_t = dp.state_template(variables, opt_state)
    assert set(var_t.params) == set(variables.params) and opt_t.step == opt_state.step
    for k, t in variables.params.items():
        lay = var_t.params[k]
        assert isinstance(lay, LeafLayout) and lay.shape == tuple(t.shape)
        assert lay.local_shape == tuple(t.shape) and lay.dtype == t.dtype and lay.owner


def test_restore_from_snapshot_onto_shrunken_mesh(tmp_path):
    """A single-rank save's snapshot restores into a smaller window (the
    layout of a rank of a larger world), without touching disk."""
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    tree = {"w": x, "s": torch.tensor(5.0)}
    captured = []
    cks.set_snapshot_listener(lambda sd, m: captured.append((sd, m)))
    cks.save_sharded_async(str(tmp_path), tree, step=3).result(timeout=60)
    assert captured
    shard_data, manifest = captured[-1]
    like = {"w": LeafLayout((8, 4), torch.float32, "cpu", window=((4, 8), (0, 4))),
            "s": LeafLayout((), torch.float32, "cpu")}
    restored, meta = cks.restore_from_snapshot(shard_data, manifest, like)
    assert int(meta["step"]) == 3
    torch.testing.assert_close(restored["w"], x[4:], rtol=0, atol=0)
    assert float(restored["s"]) == 5.0


def test_is_device_loss_classification():
    assert is_device_loss(DeviceLostError("x"))
    assert is_device_loss(RuntimeError("DATA_LOSS: device halted mid collective"))
    assert not is_device_loss(RuntimeError("shape mismatch"))
    assert not is_device_loss(ValueError("data_loss"))  # not a runtime error
    for text in (GLOO_CLOSED, GLOO_RESET, NCCL_ABORTED, NCCL_WATCHDOG):
        assert is_device_loss(RuntimeError(text)), text
    assert is_device_loss(torch.distributed.DistBackendError("NCCL error: unhandled system error"))
    # an ordinary step error in a collective's neighbourhood stays fatal
    assert not is_device_loss(RuntimeError("Tensors must be contiguous"))


def test_attribute_loss_prefers_indices_then_probe_then_rendezvous():
    """The error's indices, then the probe; with neither, nothing: the next
    generation's rendezvous attributes the ranks that never register (the
    JAX fallback, the highest-index survivor, would evict a live rank)."""
    n = 8
    sup = ElasticSupervisor(ResilienceConfig(elastic=True), devices=list(range(n)))
    assert sup._attribute_loss(DeviceLostError("x", device_indices=(2, 5))) == [2, 5]
    assert sup._attribute_loss(DeviceLostError("who knows")) == []
    sup.probe = lambda: [i for i in range(n) if i != 2]
    assert sup._attribute_loss(DeviceLostError("who knows")) == [2]
    sup.lost = {2}
    assert sup._attribute_loss(DeviceLostError("x", device_indices=(2, 6))) == [6]


def test_escalate_resets_counter_when_all_alive():
    n = 8
    sup = ElasticSupervisor(ResilienceConfig(elastic=True, elastic_escalate_stalls=1),
                            devices=list(range(n)), probe=lambda: range(n))
    sup.note_stall()
    assert sup.escalation_due()
    assert sup.escalate() is None  # everything alive
    assert not sup.escalation_due()  # counter reset
    # a probe that reports a dead rank produces an attributed loss
    sup.probe = lambda: [i for i in range(n) if i != 3]
    sup.note_stall()
    err = sup.escalate()
    assert isinstance(err, DeviceLostError) and err.device_indices == (3,)


# ---------------------------------------------------------------------------
# tentpole: shrink on a lost rank, the same trajectory as a cold restart
# ---------------------------------------------------------------------------


def test_elastic_shrink_matches_cold_restart(shrink_runs):
    """Initial rank 3 is lost at step 5: the survivors re-form at 3 ranks,
    restore step 4 and replay the epoch; their losses equal the JAX
    supervisor's (8 -> 7 devices) and a cold restart of the port on the
    same 3 ranks from the same checkpoint."""
    ranks, jax_out = shrink_runs
    survivors, lost = ranks[:3], ranks[3]
    assert lost["evicted"] and len(lost["losses"]) == 5 and lost["control_raised"]
    for r in survivors:
        assert r["control_raised"] and r["all_fired"]
        assert r["shrinks"] == 1 and r["devices"] == 3 and r["lost"] == [3]
        assert r["members"] == [0, 1, 2]
        # 5 good steps, then the interrupted epoch replays from step 4
        assert r["step_a"] == 12 and len(r["losses_a"]) == 13
        assert r["losses_a"] == survivors[0]["losses_a"]  # replicas bit-equal
        assert r["step_c"] == 12
        np.testing.assert_allclose(r["losses_a"][5:], r["losses_c"], rtol=1e-6)
    assert [r["rank_now"] for r in survivors] == [0, 1, 2]  # old rank order kept
    assert jax_out["devices"] == 7 and jax_out["rec"]["restored_step"] == 4
    np.testing.assert_allclose(survivors[0]["losses_a"], jax_out["losses"], rtol=1e-5)


def test_elastic_shrink_restores_from_disk_without_snapshot(shrink_runs):
    """With several ranks no snapshot is taken: the restore reads the last
    published serial (the JAX single-process test reads its snapshot)."""
    ranks, _ = shrink_runs
    for r in ranks[:3]:
        rec = r["recovery"]
        assert rec["source"] == "disk" and rec["restored_step"] == 4 and rec["devices"] == 3
        assert rec["members"] == [0, 1, 2] and rec["generation"] == 1
        assert rec["seconds"] < cases.COLLECTIVE_TIMEOUT_S / 4
        assert "elastic_recovery" in r["badput"] and r["shrinks_counted"] == 1


def test_elastic_shrink_event_and_stale_mesh(shrink_runs):
    """One ``elastic_shrink`` run-log event with a trace id on each
    survivor, and the mesh made before the re-form refuses to be used."""
    ranks, _ = shrink_runs
    for r in ranks[:3]:
        (ev,) = r["shrink_events"]
        assert ev["devices_before"] == 4 and ev["devices_after"] == 3
        assert ev["source"] == "disk" and ev["step"] == 4
        assert ev.get("trace_id")  # emitted inside the trainer.elastic_recover trace
        assert "generation 0" in r["stale_mesh_error"] and "remesh" in r["stale_mesh_error"]


def test_real_death_of_first_and_last_rank_recovers(death_runs):
    """Initial rank 0 (the manifest's writer) ends its process at step 3:
    the survivors learn it from gloo's error, agree through the launcher's
    health endpoint and re-form at 2; then the last rank ends likewise and
    the one survivor trains alone. Neither waits for the collective
    timeout, and each replays what the one-process Trainer trains."""
    first_dead, mid, last_dead = death_runs
    assert first_dead is None and last_dead is None
    want = _port_reference(2, 6, 6)
    for key, members in (("first", [1, 2]), ("last", [1])):
        run = mid[key]
        rec = run["recovery"]
        assert run["members"] == members and run["devices"] == len(members)
        assert rec["source"] == "disk" and rec["restored_step"] == 2 and run["step"] == 8
        assert rec["rendezvous_s"] < cases.COLLECTIVE_TIMEOUT_S / 4
        assert rec["seconds"] < cases.COLLECTIVE_TIMEOUT_S / 4
        assert len(run["losses"]) == 3 + 6
        np.testing.assert_allclose(run["losses"][3:], want, rtol=1e-6)


def test_elastic_shrink_below_min_devices_gives_up(regrow_runs):
    first, mid, _, joiner = regrow_runs
    assert first["min_error"].startswith("evicted")  # initial rank 0, the lost one
    for r in (mid, joiner):
        assert "elastic" in r["min_error"] and "elastic_min_devices" in r["min_error"]


def test_elastic_regrow_at_checkpoint_boundary(regrow_runs):
    """Initial rank 2 is lost at step 3 and leaves; a process started as
    rank 2 of generation 2 joins at the next checkpoint boundary (step 4):
    the world is 3 again and every step after it equals the one-process
    Trainer's."""
    r0, r1, left, joiner = regrow_runs
    assert left["evicted"]
    want = _port_reference(2, 6, 6)
    for r in (r0, r1):
        assert not r["joined"] and r["regrows"] == 1 and r["devices"] == 3 and r["lost"] == []
        assert r["members"] == [0, 1, 2] and r["step"] == 8 and r["regrow"]["step"] == 4
        (ev,) = r["regrow_events"]
        assert ev["devices_before"] == 2 and ev["devices_after"] == 3 and ev["step"] == 4
        assert r["regrows_counted"] >= 1
        np.testing.assert_allclose(r["losses"][3:], want, rtol=1e-6)
    assert joiner["joined"] and joiner["devices"] == 3 and joiner["step"] == 8
    assert joiner["losses"] == r0["losses"][-4:]  # the steps after the boundary, bit-equal


def test_regrow_from_one_rank_waits_for_its_background_save(one_rank_regrow_runs):
    """A world shrunk to one rank saves in the background: the regrow at
    the step-4 boundary first waits for that serial to be published, so
    the joiner loads step 4. The lost rank ended in ``EvictedError``, which
    ``may_leave`` takes as a leave."""
    survivor, left, joiner = one_rank_regrow_runs
    assert left is None
    want = _port_reference(2, 6, 6)
    assert survivor["shrinks"] == 1 and survivor["regrows"] == 1
    assert survivor["regrow"]["step"] == 4 and survivor["step"] == 8
    for r in (survivor, joiner):
        assert r["devices"] == 2 and r["members"] == [0, 1]
    np.testing.assert_allclose(survivor["losses"][3:], want, rtol=1e-6)
    assert joiner["joined"] and joiner["step"] == 8
    assert joiner["losses"] == survivor["losses"][-4:]  # the steps after the boundary, bit-equal


def test_preempt_notice_drains_final_save_and_resumes(preempt_runs):
    """faults.PREEMPT_NOTICE (kind "preempt") delivers a real SIGTERM on
    every rank: the step finishes, the ranks save and return with a resume
    marker; a fresh Trainer auto-resumes."""
    ranks = preempt_runs
    for r in ranks:
        assert r["preempt_fired"] and r["preempted"] and r["step"] == 4 and r["pending"] is None
        assert not r["resumed_preempted"]
        # resumed at step 4, replayed the interrupted epoch (8) + epoch 1 (8)
        assert r["resumed_step"] == 20
        meta = r["manifest"]  # the latest serial when the preempted run returned
        assert meta["step"] == 4 and meta["preempted"] is True and meta["next_epoch"] == 0
        assert meta["num_processes"] == 3


def test_stall_escalation_probes_and_shrinks(preempt_runs):
    """``elastic_escalate_stalls`` watchdog stalls -> liveness probe -> the
    rank it reports dead leaves through the same shrink as a raised loss,
    at the next step boundary."""
    ranks = preempt_runs
    assert ranks[2]["evicted"]
    for r in ranks[:2]:
        assert r["stall_shrinks"] == 1 and r["stall_lost"] == [2] and r["stall_devices"] == 2
        # restore from the step-4 save (checkpointing runs after the
        # EndStepEvent that queued the stalls), then the epoch replays
        assert r["stall_restored"] == 4
        assert r["stall_step"] == 12 and len(r["stall_losses"]) == 12
        assert r["stall_badput"] == pytest.approx(0.5) and r["stall_elastic"]


def _run_reforms(nprocs, init_method, losses):
    """One run of ``cases.reforms`` in ``nprocs`` fresh processes; each
    rank's list of re-forms."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=cases.reforms, args=(r, nprocs, init_method, losses, results),
                         daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    try:
        return dict(results.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


def test_reform_over_tcp_rendezvous():
    """Over ``tcp://`` the lowest survivor hosts each generation's
    rendezvous: losing initial rank 0 (the host prepared in advance), then
    the last rank, leaves groups that reduce over their members, in the
    order of their old ranks."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = _run_reforms(4, f"tcp://127.0.0.1:{port}", (0, 3))
    assert got[0] == ["evicted"]
    assert got[3] == [([1, 2, 3], 2, 3.0), "evicted"]
    assert got[1] == [([1, 2, 3], 0, 3.0), ([1, 2], 0, 2.0)]
    assert got[2] == [([1, 2, 3], 1, 3.0), ([1, 2], 1, 2.0)]


def test_relaunch_on_the_same_file_store_forms_fresh_generations(tmp_path):
    """A job relaunched on the ``file://`` path of an earlier run that
    re-formed: the first run loses rank 2 and closes generation 1 over
    [0, 1]; the second loses rank 0, and its generation 1 closes over
    [1, 2], not over the member list the first run left on disk."""
    init_method = "file://" + str(tmp_path / "store")
    first = _run_reforms(3, init_method, (2,))
    assert first == {0: [([0, 1], 0, 2.0)], 1: [([0, 1], 1, 2.0)], 2: ["evicted"]}
    assert list(tmp_path.glob("store*.gen1"))  # the first run's rendezvous stays on disk
    second = _run_reforms(3, init_method, (0,))
    assert second == {0: ["evicted"], 1: [([1, 2], 0, 2.0)], 2: [([1, 2], 1, 2.0)]}


def test_elastic_requires_parallel_and_sharded(tmp_path):
    t = Trainer(cases._linreg, cases._sgd, parallel=False, place="cpu",
                resilience=ResilienceConfig(elastic=True))
    with pytest.raises(EnforceError, match="parallel"):
        t.train(num_epochs=1, reader=cases.reader(n_batches=1))
    t2 = Trainer(cases._linreg, cases._sgd, parallel=True, place="cpu",
                 resilience=ResilienceConfig(elastic=True))
    with pytest.raises(EnforceError, match="sharded"):
        t2.train(num_epochs=1, reader=cases.reader(n_batches=1))


def test_elastic_flags_roundtrip(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ELASTIC", "1")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_MIN_DEVICES", "2")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_REGROW", "0")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_ESCALATE_STALLS", "5")
    from paddle_tpu.core.config import Flags as JFlags
    from paddle_tpu_torch.core.config import Flags

    f = Flags().load_env()
    assert f.elastic is True and f.elastic_min_devices == 2
    assert f.elastic_regrow is False and f.elastic_escalate_stalls == 5
    jf = JFlags().load_env()
    names = ("elastic", "elastic_min_devices", "elastic_regrow", "elastic_escalate_stalls")
    assert [getattr(f, k) for k in names] == [getattr(jf, k) for k in names]
    monkeypatch.setattr("paddle_tpu_torch.core.config._flags", f)
    cfg = ResilienceConfig.from_flags()
    assert cfg.elastic and cfg.elastic_min_devices == 2
    assert not cfg.elastic_regrow and cfg.elastic_escalate_stalls == 5
    # the JAX package's defaults and validation
    assert [getattr(Flags(), k) for k in names] == [getattr(JFlags(), k) for k in names]
    with pytest.raises(EnforceError, match="elastic_min_devices"):
        ResilienceConfig(elastic_min_devices=0)
    with pytest.raises(EnforceError, match="elastic_escalate_stalls"):
        ResilienceConfig(elastic_escalate_stalls=0)
