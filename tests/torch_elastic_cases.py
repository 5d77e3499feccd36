"""Rank bodies of the port's elastic tests (``test_torch_elastic.py``).

Each function runs as one rank of a gloo group on the CPU, spawned by
``paddle_tpu_torch.parallel.launch.spawn`` (``may_leave`` names the ranks a
case loses on purpose, ``join`` the process that comes back): it imports
only numpy, torch and the port (never JAX) and returns plain Python and
numpy results, which the test holds against the JAX package's supervisor
and against the port's own reference runs in the parent process.

The model is the JAX elastic test's linear regression
(``tests/test_elastic.py``: its reader, seed 7, SGD at 0.1, a sharded
checkpoint every 2 steps) with a constant initializer, so that both
packages start from the same weights.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: its share of the cores)
import json
import os
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.observability.runlog import RunLog, read_runlog, set_runlog
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.parallel.mesh import EvictedError
from paddle_tpu_torch.resilience import ResilienceConfig, faults
from paddle_tpu_torch.resilience.faults import DeviceLostError
from paddle_tpu_torch.trainer import BeginStepEvent, CheckpointConfig, EndStepEvent, Trainer

COLLECTIVE_TIMEOUT_S = 60.0


def linreg_net(pkg, mean):
    """The JAX elastic test's model, for either package, with a constant
    initializer (the packages' random initializers differ)."""

    def model():
        def net(x, y):
            attr = pkg.ParamAttr(initializer=pkg.initializer.Constant(0.1))
            pred = pkg.layers.fc(x, size=1, param_attr=attr)
            return mean(pkg.ops.nn.square_error_cost(pred, y))

        return net

    return model


def reader(n_batches=8, bs=8, seed=7):
    """The JAX elastic test's reader (``tests/test_elastic.py::_reader``)."""

    def read():
        rng = np.random.RandomState(seed)
        w = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
        for _ in range(n_batches):
            x = rng.randn(bs, 4).astype(np.float32)
            yield x, x @ w

    return read


_linreg = linreg_net(pt, torch.mean)


def _sgd():
    return pt.optimizer.SGD(learning_rate=0.1)


def trainer(root, elastic=True, **res_kw):
    return Trainer(
        _linreg, _sgd, parallel=True, place="cpu",
        checkpoint_config=CheckpointConfig(root, step_interval=2, sharded=True, async_save=True),
        resilience=ResilienceConfig(elastic=elastic, **res_kw))


def lost_spec(after, lost_index):
    return faults.FaultSpec(
        faults.DEVICE_LOST, "error", after=after, times=1,
        exc=DeviceLostError("injected device loss", device_indices=(lost_index,)))


class _Collect:
    """Every EndStepEvent's loss, and an optional hook per BeginStepEvent."""

    def __init__(self, on_begin=None):
        self.losses = []
        self.on_begin = on_begin

    def __call__(self, ev):
        if isinstance(ev, EndStepEvent) and ev.metrics is not None:
            self.losses.append(ev.metrics)
        if isinstance(ev, BeginStepEvent) and self.on_begin is not None:
            self.on_begin(ev)


def _runlog(path):
    set_runlog(RunLog(path))
    return path


def _events(path, kind):
    set_runlog(None)
    return [e for e in read_runlog(path) if e["kind"] == kind]


def _die_at(step, rank, generation):
    """A BeginStepEvent hook: the process of initial rank ``rank`` ends at
    ``step`` of a run in process-group generation ``generation``, as a
    crashed host does (no cleanup, no result)."""

    def hook(ev):
        if (ev.step == step and mesh_mod.initial_rank() == rank
                and mesh_mod.generation() == generation):
            os._exit(1)

    return hook


# -- cases -------------------------------------------------------------------
def shrink(rank, root_a, root_b, log_dir):
    """The tentpole at 4 ranks: (b) the loss WITHOUT elastic is fatal on
    every rank; (a) with elastic, initial rank 3 is lost at step 5 and the
    survivors re-form at 3 ranks, restore step 4 and replay the epoch;
    (c) the survivors' group cold-restarts from (b)'s step-4 serial."""
    out = {}
    handler_b = _Collect()
    with faults.injected(lost_spec(after=5, lost_index=3)):
        tb = trainer(root_b, elastic=False)
        try:
            tb.train(num_epochs=1, reader=reader(), event_handler=handler_b)
            out["control_raised"] = False
        except DeviceLostError:
            out["control_raised"] = True
    log = _runlog(os.path.join(log_dir, f"rank{rank}.jsonl"))
    seen = {}
    handler_a = _Collect(on_begin=lambda ev: seen.setdefault("mesh", ta._dp.mesh))
    shrinks0 = prof.counters().get("elastic.shrinks_total", 0)
    with faults.injected(lost_spec(after=5, lost_index=3)) as plan:
        ta = trainer(root_a)
        try:
            ta.train(num_epochs=1, reader=reader(), event_handler=handler_a)
        except EvictedError as e:
            set_runlog(None)
            return {"evicted": str(e), "losses": handler_a.losses, **out}
        out["all_fired"] = plan.all_fired()
    try:  # the mesh made before the re-form holds dead group handles
        seen["mesh"].group("data")
        out["stale_mesh_error"] = None
    except EnforceError as e:
        out["stale_mesh_error"] = str(e)
    out.update(
        losses_a=handler_a.losses, step_a=ta.global_step, shrinks=ta._elastic.shrinks,
        devices=ta._dp.num_devices, recovery=ta._elastic.last_recovery,
        lost=sorted(ta._elastic.lost), rank_now=mesh_mod.process_rank(),
        members=mesh_mod.members(), badput=sorted(ta.goodput.badput_by_category()),
        shrinks_counted=prof.counters().get("elastic.shrinks_total", 0) - shrinks0,
        shrink_events=_events(log, "elastic_shrink"))
    ta.stop()
    handler_c = _Collect()
    tc = trainer(root_b, elastic=False)
    tc.train(num_epochs=1, reader=reader(), event_handler=handler_c, allow_ragged=True)
    out.update(losses_c=handler_c.losses, step_c=tc.global_step)
    tc.stop()
    return out


def real_deaths(rank, root_1, root_2):
    """Two real deaths at 3 ranks: initial rank 0 (the manifest's writer)
    ends its process at step 3, the survivors re-form at 2 and finish the
    epoch; then, in a new run on those 2, the last rank ends at step 3 and
    the one survivor finishes alone."""
    out = {}
    for key, root, die, generation in (("first", root_1, 0, 0), ("last", root_2, 2, 1)):
        handler = _Collect(on_begin=_die_at(3, die, generation))
        t = trainer(root)
        t.train(num_epochs=1, reader=reader(n_batches=6, bs=6), event_handler=handler)
        out[key] = dict(losses=handler.losses, step=t.global_step, devices=t._dp.num_devices,
                        recovery=t._elastic.last_recovery, members=mesh_mod.members())
        t.stop()
    return out


def regrow_and_min(rank, root, root_min, log_dir):
    """Regrow at 3 ranks: initial rank 2 is lost at step 3 (it leaves), the
    survivors re-form at 2 and restore step 2; a process started as rank 2
    of generation 2 waits at that rendezvous and joins at the next
    checkpoint boundary (step 4), and the three finish the epoch. Then,
    on those three, a run with ``elastic_min_devices=3`` loses initial
    rank 0: the two survivors give up."""
    log = _runlog(os.path.join(log_dir, f"rank{rank}_g{mesh_mod.generation()}.jsonl"))
    joined = mesh_mod.generation() > 0
    handler = _Collect()
    spec = [] if joined else [lost_spec(after=3, lost_index=2)]
    with faults.injected(*spec):
        t = trainer(root)
        try:
            t.train(num_epochs=1, reader=reader(n_batches=6, bs=6), event_handler=handler)
        except EvictedError as e:
            set_runlog(None)
            return {"evicted": str(e)}
    out = dict(joined=joined, losses=handler.losses, step=t.global_step,
               devices=t._dp.num_devices, regrows=t._elastic.regrows, lost=sorted(t._elastic.lost),
               regrow=t._elastic.last_regrow, members=mesh_mod.members(),
               regrow_events=_events(log, "elastic_regrow"),
               regrows_counted=prof.counters().get("elastic.regrows_total", 0))
    t.stop()
    with faults.injected(lost_spec(after=1, lost_index=0)):
        tm = trainer(root_min, elastic_min_devices=3)
        try:
            tm.train(num_epochs=1, reader=reader(n_batches=6, bs=6))
            out["min_error"] = None
        except EvictedError as e:
            out["min_error"] = "evicted: " + str(e)
        except EnforceError as e:
            out["min_error"] = str(e)
    return out


def regrow_from_one_rank(rank, root):
    """2 ranks shrink to 1 and regrow: initial rank 1 is lost at step 3
    and lets the ``EvictedError`` end its body (``launch.spawn``'s
    ``may_leave`` takes that as a leave). The one survivor saves in the
    background, each write slowed by a second here, so the step-4 serial is
    still being written when the process started as rank 1 of generation 2
    is taken in at that boundary; the joiner loads that serial."""
    from paddle_tpu_torch import checkpoint_sharded as cks

    write = cks._write_publish_local

    def slow_write(*args, **kwargs):
        time.sleep(1.0)
        return write(*args, **kwargs)

    cks._write_publish_local = slow_write
    joined = mesh_mod.generation() > 0
    handler = _Collect()
    with faults.injected(*([] if joined else [lost_spec(after=3, lost_index=1)])):
        t = trainer(root)
        t.train(num_epochs=1, reader=reader(n_batches=6, bs=6), event_handler=handler)
    out = dict(joined=joined, losses=handler.losses, step=t.global_step,
               devices=t._dp.num_devices, shrinks=t._elastic.shrinks, regrows=t._elastic.regrows,
               regrow=t._elastic.last_regrow, members=mesh_mod.members())
    t.stop()
    return out


def preempt_and_stall(rank, root_p, root_s):
    """Preemption and stall escalation at 3 ranks: a PREEMPT_NOTICE at
    step 3 drains the boundary save and returns; a new Trainer resumes
    and runs two epochs. Then two watchdog stalls after step 3 with a
    probe that reports initial rank 2 dead: the probe's loss shrinks the
    world at the next step boundary."""
    out = {}
    with faults.injected(faults.FaultSpec(faults.PREEMPT_NOTICE, "preempt", after=3,
                                          times=1)) as plan:
        t = trainer(root_p)
        t.train(num_epochs=2, reader=reader(bs=6))
        out["preempt_fired"] = plan.all_fired()
    from paddle_tpu_torch import checkpoint_sharded as cks

    out.update(preempted=t.preempted, step=t.global_step, pending=cks.wait_pending_save())
    with open(os.path.join(cks.latest_sharded_checkpoint(root_p), "manifest.json")) as f:
        out["manifest"] = json.load(f)
    t.stop()
    t2 = trainer(root_p)
    t2.train(num_epochs=2, reader=reader(bs=6))
    out.update(resumed_preempted=t2.preempted, resumed_step=t2.global_step)
    t2.stop()

    ts = trainer(root_s, elastic_escalate_stalls=2)
    losses = []

    def handler(ev):
        if not isinstance(ev, EndStepEvent):
            return
        losses.append(ev.metrics)
        if ev.epoch == 0 and ev.step == 3 and ts._elastic.shrinks == 0:
            ts._elastic.probe = lambda: [0, 1]
            # two stalls, as the watchdog's on_stall would deliver them
            ts._on_stall("epoch 0 step 3", 0.25)
            ts._on_stall("epoch 0 step 3", 0.25)

    try:
        ts.train(num_epochs=1, reader=reader(bs=6), event_handler=handler)
    except EvictedError as e:
        return {**out, "evicted": str(e)}
    bad = ts.goodput.badput_by_category()
    out.update(stall_losses=losses, stall_step=ts.global_step, stall_shrinks=ts._elastic.shrinks,
               stall_lost=sorted(ts._elastic.lost), stall_devices=ts._dp.num_devices,
               stall_restored=ts._elastic.last_recovery["restored_step"],
               stall_badput=bad.get("stall"), stall_elastic="elastic_recovery" in bad)
    ts.stop()
    return out


def reforms(rank, nprocs, init_method, losses, results):
    """One run of a job of ``nprocs`` ranks on the rendezvous
    ``init_method``: the initial ranks in ``losses`` are lost one after the
    other; after each re-form an all-reduce runs over the new group."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method=init_method, num_processes=nprocs,
                                    process_id=rank, device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    out = []
    try:
        mesh_mod.prepare_reform()
        for lost in losses:
            try:
                form = mesh_mod.reform([lost])
            except EvictedError:
                out.append("evicted")
                break
            x = torch.ones(1)
            dist.all_reduce(x)
            out.append((form["members"], dist.get_rank(), float(x)))
    finally:
        mesh_mod.shutdown_distributed()
    results.put((rank, out))
