"""High-level Trainer with event callbacks, auto-checkpoint and auto-resume.

Port of ``paddle_tpu/trainer.py``. Reference:
``python/paddle/fluid/trainer.py:169`` (Trainer(train_func, optimizer_func)
driving train_loop with Begin/EndEpochEvent + Begin/EndStepEvent
callbacks), ``trainer.py:100`` (CheckpointConfig), ``trainer.py:594,663,763``
(auto-resume on init, save_checkpoint per epoch/step interval, trainer
metadata).

The step is ``Optimizer.minimize(model)`` run eagerly through the
:class:`Executor` on one device (CUDA unless ``place="cpu"``), or with
``parallel=True`` :class:`paddle_tpu_torch.parallel.DataParallel`'s step:
every rank (one process per card) runs the Trainer over the same reader,
and each steps on its rows of every global batch. Per step the host waits
on the card only for ``float(loss)`` (when the handler keeps
``fetch_metrics`` on) and ``bool(finite)`` (when ``check_nan_inf`` is
on), as in the JAX package. Checkpoints use the JAX package's formats, the
single-file one or the sharded one (``CheckpointConfig(sharded=,
async_save=)``), so either package resumes the other's.

Telemetry as in the JAX package: ``observability=`` starts the exporter
and the run log (:func:`paddle_tpu_torch.observability.setup`), ``watch=``
attaches anomaly detectors and SLOs (:func:`paddle_tpu_torch.watch.build`).
Each step is a ``trainer.step`` trace with ``trainer.data_wait``,
``trainer.h2d``, ``trainer.step_compute`` and ``trainer.checkpoint``
spans; a good step books goodput, MFU (the step's FLOPs counted once, on
its first call, by :class:`~paddle_tpu_torch.observability.mfu.CostCounter`,
over the card's peak), the device-memory gauges and the straggler
watch; NaN-skipped steps, rollbacks and watchdog stalls are badput.
Under ``parallel=True`` each rank counts its own rows' step and divides by
its own card.

Elastic training (``ResilienceConfig(elastic=True)``, with ``parallel=True``
and ``CheckpointConfig(sharded=True)``): an
:class:`~paddle_tpu_torch.resilience.elastic.ElasticSupervisor` turns the
loss of a rank into a re-formed process group over the survivors, restored
at the new world size from the last published serial, and the interrupted
epoch replays from there; at a checkpoint boundary a rank that came back
regrows the world. A process started with
:func:`~paddle_tpu_torch.parallel.mesh.join_generation` (``launch.spawn``'s
``join``) is such a rank: its Trainer takes the training position from a
survivor and loads the boundary's checkpoint instead of initializing.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import checkpoint as ckpt_mod
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import tracing
from paddle_tpu_torch.checkpoint import CheckpointConfig
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.framework import Model, Variables, build
from paddle_tpu_torch.observability import mfu as obs_mfu
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.optimizer import Optimizer, OptState, StepOutput
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.resilience import ResilienceConfig, faults
from paddle_tpu_torch.resilience import elastic as elastic_mod
from paddle_tpu_torch.resilience.watchdog import StepWatchdog

__all__ = [
    "Trainer",
    "BeginEpochEvent",
    "EndEpochEvent",
    "BeginStepEvent",
    "EndStepEvent",
    "CheckpointConfig",
    "ResilienceConfig",
]


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        # mirrors reference BeginStepEvent.fetch_metrics (trainer.py:158)
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class Trainer:
    """Drive training of a built Model with events + checkpointing.

    ``train_func`` builds and returns the model (a :class:`Model` or a plain
    layer-calling function, which is wrapped); its forward must return the
    loss first. ``optimizer_func`` returns an :class:`Optimizer`. ``place``
    is the device (default CUDA, or with ``parallel=True`` the rank's card
    from ``initialize_distributed``; ``"cpu"`` runs the plain PyTorch
    path). ``parallel_kwargs`` go to ``DataParallel`` (``mesh=``,
    ``zero_shard_optimizer=``, ...; ``batch_outputs`` defaults to ``()``:
    the loop reads only the loss, so no output is gathered). ``variables`` and ``opt_state`` may be
    set before ``train()``, which then neither initializes nor resumes.
    """

    def __init__(
        self,
        train_func: Callable[[], Any],
        optimizer_func: Callable[[], Optimizer],
        place=None,
        parallel: bool = False,
        checkpoint_config: Optional[CheckpointConfig] = None,
        rng: Optional[int] = 0,
        parallel_kwargs: Optional[dict] = None,
        prefetch: bool = False,
        resilience: Optional[ResilienceConfig] = None,
        observability: Optional["obs.ObservabilityConfig"] = None,
        watch: Optional[Any] = None,
    ):
        self.resilience = resilience if resilience is not None else ResilienceConfig.from_flags()
        # flags-driven (or explicit) telemetry: exporter + runlog, idempotent
        obs.setup(observability)
        model = train_func()
        self.model = model if isinstance(model, Model) else build(model)
        self.optimizer = optimizer_func()
        self.parallel = parallel
        # extra DataParallel options (mesh=..., zero_shard_optimizer=True, ...)
        self.parallel_kwargs = dict(parallel_kwargs or {})
        if place is None and parallel:
            place = mesh_mod.process_device()
        # async host->device double buffering of reader batches (the
        # reference's double_buffer reader, operators/reader/buffered_reader.cc)
        self.prefetch = prefetch
        self.checkpoint_cfg = checkpoint_config
        self.rng = rng
        self.place = place
        self.exe = Executor(place)
        self.trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._dp = None
        self._allow_ragged = False
        self._step_fn = None
        self.variables: Optional[Variables] = None
        self.opt_state: Optional[OptState] = None
        self.epoch = 0
        self.global_step = 0
        self._last_saved_step = -1
        # preemption-aware save: SIGTERM during train() is caught at the next
        # step boundary → checkpoint + clean return. True after train()
        # returned early because of a signal.
        self.preempted = False
        self._preempt_requested = False
        self.bad_steps = 0  # non-finite steps whose update was dropped
        self.rollbacks = 0  # checkpoint restores triggered by the nan policy
        self._consec_bad = 0
        self._rollbacks_since_good = 0
        self._watchdog: Optional[StepWatchdog] = None
        # elastic training (resilience.elastic), set up with the state
        self._elastic: Optional[elastic_mod.ElasticSupervisor] = None
        self._step_in_epoch = -1  # the step just taken, within its epoch
        self._join_skip = 0  # batches a returning rank skips in its first epoch
        # -- telemetry (paddle_tpu_torch.observability / .tracing) ---------
        self.goodput = obs_mfu.GoodputTracker()
        self._ema_eps: Optional[float] = None  # EMA examples/sec
        # FLOPs of one step, counted on its first call (None until then)
        self._step_flops: Optional[float] = None
        # temporal skew watch over step durations: a step that blows past
        # this trainer's own recent median gets flagged
        self._straggler = tracing.StragglerDetector("trainer.step")
        # watch layer: anomaly detectors / SLOs over this trainer's metric
        # streams (step time, MFU, goodput), attached via config
        # (a paddle_tpu_torch.watch.WatchConfig; None = no watching)
        self._watcher = None
        if watch is not None:
            from paddle_tpu_torch import watch as watch_mod

            self._watcher = watch_mod.build(watch)

    # -- init / resume ------------------------------------------------------
    def _ensure_initialized(self, first_batch: Sequence[Any]):
        if self.variables is not None:
            return
        if self.parallel:
            from paddle_tpu_torch.parallel import DataParallel

            kw = dict(self.parallel_kwargs)
            kw.setdefault("mesh", mesh_mod.default_mesh())
            kw.setdefault("device", self.exe.device)
            kw.setdefault("batch_outputs", ())  # the loop reads only the loss
            self._dp = DataParallel(self.model, self.optimizer, **kw)
            join_source = mesh_mod.take_join_source() if self.resilience.elastic else None
            if join_source is not None:
                self._start_elastic()
                self._join_running(first_batch, join_source)
                return
            self.variables, self.opt_state = self._dp.init(self.rng, *first_batch)
        else:
            self.variables = self.model.init(self.rng, *self.exe.put(tuple(first_batch)),
                                             device=self.exe.device)
            self.opt_state = self.optimizer.create_state(self.variables.params)
        if self.resilience.elastic:
            self._start_elastic()
        # auto-resume (reference Trainer.__init__ -> _load_checkpoint,
        # trainer.py:594-629)
        if self.checkpoint_cfg is not None:
            root = self.checkpoint_cfg.checkpoint_dir
            sharded = self.checkpoint_cfg.use_sharded()
            if cks.latest_sharded_checkpoint(root) if sharded else ckpt_mod.latest_checkpoint(root):
                meta = self._load_checkpoint()
                # next_epoch: epoch+1 for end-of-epoch saves, same epoch for
                # mid-epoch saves (reference restarts the interrupted epoch)
                self.epoch = int(meta.get("next_epoch", meta.get("epoch", 0)))
                self.global_step = int(meta.get("step", 0))
                self._last_saved_step = self.global_step
                ptlog.vlog(
                    0, "resumed from %s checkpoint: continuing at epoch %d step %d",
                    "sharded" if sharded else "the", self.epoch, self.global_step,
                )

    def _start_elastic(self) -> None:
        """The JAX package's guards, then the supervisor over the initial
        world's ranks (those no longer in the group are lost), fed every
        single-rank save's snapshot."""
        enforce(self.parallel, "elastic training requires parallel=True (a world to shrink)")
        enforce(
            self.checkpoint_cfg is not None and self.checkpoint_cfg.use_sharded(),
            "elastic training needs CheckpointConfig(sharded=True) — "
            "its serials are the recovery source",
        )
        from paddle_tpu_torch.parallel import launch

        if mesh_mod.generation() == 0:
            mesh_mod.prepare_reform()
        self._elastic = elastic_mod.ElasticSupervisor(
            self.resilience, devices=list(range(mesh_mod.initial_world_size())),
            probe=launch.health_probe())
        self._elastic.lost = set(self._elastic.all_devices) - set(mesh_mod.members())
        cks.set_snapshot_listener(self._elastic.note_snapshot)

    def _join_running(self, first_batch, source: int) -> None:
        """A returning rank (it joined a later generation of the group):
        the survivors' training position, broadcast by ``source`` at the
        checkpoint boundary where they took it in
        (``ElasticSupervisor.maybe_regrow``), and that boundary's
        checkpoint, restored at this world's layout. Nothing here is
        collective but the broadcast: the parameters are this rank's own
        init, only as a template."""
        import torch.distributed as dist

        position = [None]
        dist.broadcast_object_list(position, src=source)
        pos = position[0]
        variables = self.model.init(self.rng, *self.exe.put(tuple(first_batch)),
                                    device=self.exe.device)
        opt_state = self.optimizer.create_state(variables.params)
        template = self._dp.state_template(variables, opt_state)
        (self.variables, self.opt_state), meta = cks.load_sharded(
            self.checkpoint_cfg.checkpoint_dir, template)
        enforce(int(meta.get("step", -1)) == int(pos["global_step"]),
                f"regrow: the latest checkpoint holds step {meta.get('step')}, the survivors "
                f"stand at step {pos['global_step']}")
        self.epoch, self.global_step = int(pos["epoch"]), int(pos["global_step"])
        self._last_saved_step = self.global_step
        self._join_skip = int(pos["step_id"]) + 1
        self._allow_ragged = bool(pos["allow_ragged"])
        self._elastic.adopt(pos)
        ptlog.vlog(0, "joined the running world at epoch %d step %d (global step %d)",
                   self.epoch, self._join_skip, self.global_step)

    def _load_checkpoint(self) -> dict:
        """Restore the latest checkpoint into the training state (corrupt
        serials already fall back inside the loaders); returns its
        metadata. Sharded: each rank reads its own window of every leaf.
        The single-file layout holds whole slots, which a ZeRO-1 rank then
        cuts to its rows."""
        root = self.checkpoint_cfg.checkpoint_dir
        tree = (self.variables, self.opt_state)
        if self.checkpoint_cfg.use_sharded():
            cks.wait_pending_save()
            target = self._dp.state_template(*tree) if self._dp is not None else tree
            tree, meta = cks.load_sharded(root, target)
        else:
            tree, meta = ckpt_mod.load_checkpoint(root, tree, self.trainer_id)
            if self._dp is not None:
                tree = self._dp.place_state(*tree)
        self.variables, self.opt_state = tree
        return meta

    def _compiled_step(self):
        if self._step_fn is None:
            raw = self.optimizer.minimize(self.model)
            self._step_fn = self.exe.prepare(raw, key=("trainer_step", id(self)))
        return self._step_fn

    # -- train loop ---------------------------------------------------------
    def train(
        self,
        num_epochs: int,
        event_handler: Optional[Callable[[Any], None]] = None,
        reader: Optional[Callable[[], Iterable[Tuple]]] = None,
        allow_ragged: bool = False,
    ):
        """Run the training loop (reference ``Trainer.train`` →
        ``_train_by_executor``/``_train_by_parallel_executor``,
        trainer.py:404,541).

        ``allow_ragged``: in parallel mode, a batch whose leading dim does
        not divide the mesh trains through ``DataParallel.step_ragged``
        (every rank steps on the whole batch: numerically a single-device
        step) instead of raising, so ``drop_last=False`` readers train on
        EVERY sample, the reference's data_balance guarantee
        (``details/data_balance_op_handle.cc:154``)."""
        enforce(reader is not None, "Trainer.train needs a batched reader")
        self._allow_ragged = allow_ragged
        handler = event_handler or (lambda event: None)
        # a Trainer may be re-entered after a preempted run (in-process
        # resume): stale flags must not end the new loop after one step
        self.preempted = False
        self._preempt_requested = False
        # initialize (and auto-resume) BEFORE choosing the start epoch, so a
        # fresh Trainer with a checkpoint on disk skips completed epochs
        if self.variables is None:
            first = next(iter(reader()), None)
            enforce(first is not None, "reader yielded no batches")
            self._ensure_initialized(first)
        if self._elastic is not None and self._elastic.lost:
            # re-entered after an elastic shrink: the global batch may not
            # divide the shrunken world — keep the ragged path open
            self._allow_ragged = True
        prev_handlers = self._install_preemption_handlers()
        res = self.resilience
        if res.stall_timeout_s is not None and self._watchdog is None:
            self._watchdog = StepWatchdog(res.stall_timeout_s, on_stall=self._on_stall)
        try:
            # while (not for-range): elastic recovery rewinds self.epoch to
            # the restored checkpoint's epoch and restarts it — the same
            # restart-the-interrupted-epoch semantics a cold resume has
            epoch_id = self.epoch
            while epoch_id < num_epochs:
                self.epoch = epoch_id
                handler(BeginEpochEvent(epoch_id))
                # manual next() instead of a for-loop: the wait for the
                # reader is measured and belongs INSIDE the step's trace
                batches = iter(self._batches(reader))
                step_id = -1
                # a returning rank steps in where the survivors stand
                skip, self._join_skip = self._join_skip, 0
                for _ in range(skip):
                    next(batches, None)
                    step_id += 1
                recovered = False
                while True:
                    # stall escalation: between steps (state consistent) ask
                    # the supervisor to probe liveness; a dead rank recovers
                    # through the same shrink path as a raised loss
                    if self._elastic is not None and self._elastic.escalation_due():
                        probe_err = self._elastic.escalate()
                        if probe_err is not None:
                            self._elastic.recover(self, probe_err)
                            recovered = True
                            break
                    t_wait0 = time.perf_counter()
                    batch = next(batches, None)
                    t_wait1 = time.perf_counter()
                    if batch is None:
                        break
                    step_id += 1
                    try:
                        self._train_step(handler, epoch_id, step_id, batch, t_wait0, t_wait1)
                    except Exception as e:
                        if self._elastic is None or not elastic_mod.is_device_loss(e):
                            raise
                        # a lost rank: re-form over the survivors, restore
                        # the last serial, restart the interrupted epoch
                        # from the restored step
                        self._elastic.recover(self, e)
                        recovered = True
                        break
                    if self.preempted:
                        return
                if recovered:
                    epoch_id = self.epoch  # the restored manifest's epoch
                    continue
                handler(EndEpochEvent(epoch_id))
                with tracing.start_span("trainer.checkpoint", boundary="epoch"):
                    self._maybe_checkpoint(epoch_id, step=False)
                if self._preempt_requested:
                    # the epoch just COMPLETED — resume must not re-train it
                    self._preemption_save(next_epoch=epoch_id + 1)
                    return
                epoch_id += 1
        finally:
            self._restore_signal_handlers(prev_handlers)
            if self._watchdog is not None:
                self._watchdog.close()
                self._watchdog = None
            if self.checkpoint_cfg is not None and self.checkpoint_cfg.async_save:
                unwinding = sys.exc_info()[1] is not None
                try:
                    cks.wait_pending_save()  # train() returning => saves durable
                except Exception as e:
                    if not unwinding:  # clean exit: "train() returned" must
                        raise  # imply a durable save
                    # the loop is already unwinding with its own exception —
                    # log the writer failure instead of masking the cause
                    ptlog.error("async checkpoint writer failed during train() exit: %s", e)

    def _train_step(self, handler, epoch_id: int, step_id: int, batch, t_wait0: float,
                    t_wait1: float) -> None:
        """One step of the loop, in its ``trainer.step`` trace: the events,
        the fault points, the step, the bad-step policy, then the boundary
        work (a preemption's save, the periodic checkpoint, an elastic
        regrow)."""
        with tracing.start_trace("trainer.step", epoch=epoch_id) as step_span:
            # the step trace begins where the data wait began
            step_span.t0_us = t_wait0 * 1e6
            step_span.set(step=self.global_step)
            tracing.record_span("trainer.data_wait", t_wait0, t_wait1)
            begin_ev = BeginStepEvent(epoch_id, step_id)
            handler(begin_ev)
            # elastic fault points: a scheduler's advance preemption notice
            # ("preempt" -> SIGTERM, handled at the boundary below) and a rank
            # vanishing ("error" -> DeviceLostError, recovered by the loop)
            faults.inject(faults.PREEMPT_NOTICE, epoch=epoch_id, step=step_id)
            faults.inject(faults.DEVICE_LOST, epoch=epoch_id, step=step_id)
            # fault point: "error" raises here (a crashing step), "nan" forces
            # this step to count as non-finite, "preempt" delivers SIGTERM
            # (handled at the boundary below); as in the JAX package it sits
            # before the step's timed region, so a "stall" here is not step time
            spec = faults.inject(faults.TRAINER_STEP, epoch=epoch_id, step=step_id)
            t_step = time.perf_counter()
            if self._watchdog is not None:
                with self._watchdog.watch(f"epoch {epoch_id} step {step_id}"):
                    out = self._run_step(batch)
            else:
                out = self._run_step(batch)
            bad = (out.finite is not None and not bool(out.finite)) or (
                spec is not None and spec.kind == "nan"
            )
            if bad:
                step_span.set(status="bad_step")
                # charge the wasted step to badput even if the policy raises
                # below — the accounting outlives the run
                self.goodput.record_bad(time.perf_counter() - t_step, "nan_skip")
                # may raise (policy "raise", or rollback gave up)
                self._handle_bad_step(epoch_id, step_id)
                metrics = float("nan") if begin_ev.fetch_metrics else None
            else:
                self._consec_bad = 0
                self._rollbacks_since_good = 0
                self.variables, self.opt_state = out.variables, out.opt_state
                self.global_step += 1
                # honoring fetch_metrics avoids a host sync per step
                # (reference BeginStepEvent.fetch_metrics, trainer.py:158)
                metrics = float(out.loss) if begin_ev.fetch_metrics else None
                self._record_step(epoch_id, batch, time.perf_counter() - t_step,
                                  metrics)
            # the step's outputs (an LM's logits) must not live through the
            # next step
            del out
            self._step_in_epoch = step_id
            handler(EndStepEvent(epoch_id, step_id, metrics))
            if self._preempt_requested:
                with tracing.start_span("trainer.checkpoint", reason="preempt"):
                    self._preemption_save(next_epoch=epoch_id)
                return
            with tracing.start_span("trainer.checkpoint"):
                self._maybe_checkpoint(epoch_id, step=True)
            if self._elastic is not None:
                # regrow only at a checkpoint boundary (the supervisor
                # checks; state is durable there)
                self._elastic.maybe_regrow(self)

    # -- telemetry ----------------------------------------------------------
    def _record_step(self, epoch_id: int, batch, dt: float, loss: Optional[float]) -> None:
        """Registry + runlog record for one GOOD step: step-time histogram,
        throughput gauges (instant + EMA), goodput, MFU from the step's
        counted FLOPs, the device-memory gauges and the straggler watch."""
        rows = int(np.shape(batch[0])[0]) if len(batch) else 0
        eps = rows / dt if dt > 0 else 0.0
        self._ema_eps = eps if self._ema_eps is None else 0.9 * self._ema_eps + 0.1 * eps
        prof.inc_counter("trainer.steps_total")
        prof.inc_counter("trainer.examples_total", rows)
        prof.observe("trainer.step_seconds", dt)
        prof.set_gauge("trainer.examples_per_sec", eps)
        prof.set_gauge("trainer.examples_per_sec_ema", self._ema_eps)
        if loss is not None:
            prof.set_gauge("trainer.loss", loss)
        self.goodput.record_good(dt)
        prof.set_gauge("trainer.goodput_frac", self.goodput.goodput_frac())
        mfu_val = None
        if self._step_flops:
            # each rank counted its own rows' step: one card's share
            mfu_val = obs_mfu.mfu(self._step_flops, dt,
                                  peak_per_device=obs_mfu.peak_flops(self.exe.device))
            if mfu_val is not None:
                prof.set_gauge("trainer.mfu", mfu_val)
        extra = {"mfu": round(mfu_val, 6)} if mfu_val is not None else {}
        runlog.emit(
            "step", step=self.global_step, epoch=epoch_id, loss=loss,
            step_time_s=round(dt, 6), examples_per_sec=round(eps, 3),
            ema_examples_per_sec=round(self._ema_eps, 3), **extra)
        # per-device memory gauges (device.hbm.*; on the CPU the training
        # state's bytes) + temporal straggler watch: a step far above this
        # trainer's own recent median gets flagged
        tracing.sample_device_memory([self.exe.device],
                                     tensors=(self.variables, self.opt_state))
        self._straggler.record("step", dt)

    def _on_stall(self, tag: str, elapsed: float) -> None:
        # the watchdog already logged stacks + runlog'd the stall; charge
        # the stalled wall time against goodput here (trainer-side policy)
        self.goodput.record_bad(elapsed, "stall")
        prof.set_gauge("trainer.goodput_frac", self.goodput.goodput_frac())
        if self._elastic is not None:
            # repeated stalls escalate to a liveness probe (between steps)
            self._elastic.note_stall()

    # -- self-healing (resilience.ResilienceConfig) -------------------------
    def _handle_bad_step(self, epoch_id: int, step_id: int) -> None:
        """A non-finite step (in-step check_nan_inf, or an injected "nan"
        fault). Policy "raise" is fatal; "skip_step" drops the update and
        continues; "rollback" additionally restores the last good checkpoint
        after ``rollback_after`` CONSECUTIVE bad steps — and gives up
        (raises) after ``max_rollbacks`` restores with no good step in
        between."""
        res = self.resilience
        msg = (
            f"NaN/Inf in loss or gradients at epoch {epoch_id} "
            f"step {step_id} (check_nan_inf)"
        )
        if res.nan_policy == "raise":
            raise EnforceError(msg)
        self.bad_steps += 1
        self._consec_bad += 1
        prof.inc_counter("resilience.bad_steps")
        runlog.emit("nan_skip", step=self.global_step, epoch=epoch_id,
                    consecutive=self._consec_bad)
        ptlog.warning(
            "%s — policy %r: update dropped (%d consecutive bad)",
            msg, res.nan_policy, self._consec_bad,
        )
        if res.nan_policy == "skip_step" or self._consec_bad < res.rollback_after:
            return
        enforce(
            self.checkpoint_cfg is not None,
            f"nan_policy='rollback' needs a checkpoint_config to restore from ({msg})",
        )
        enforce(
            self._rollbacks_since_good < res.max_rollbacks,
            f"giving up after {self._rollbacks_since_good} rollbacks without "
            f"a good step in between ({msg})",
        )
        self._rollback()

    def _rollback(self) -> None:
        """Restore params + optimizer state from the last good checkpoint
        (corrupt serials already fall back inside the loaders)."""
        cfg = self.checkpoint_cfg
        root = cfg.checkpoint_dir
        t0 = time.perf_counter()
        rolled_back_from = self.global_step
        if cfg.use_sharded():
            cks.wait_pending_save()
        latest = cks.latest_sharded_checkpoint(root) if cfg.use_sharded() else \
            ckpt_mod.latest_checkpoint(root)
        enforce(latest is not None, f"rollback: no checkpoint under {root} to restore")
        meta = self._load_checkpoint()
        self.global_step = int(meta.get("step", self.global_step))
        self._last_saved_step = self.global_step
        self.rollbacks += 1
        self._rollbacks_since_good += 1
        self._consec_bad = 0
        prof.inc_counter("resilience.rollbacks")
        restore_s = time.perf_counter() - t0
        self.goodput.record_bad(restore_s, "rollback")
        runlog.emit("rollback", step=self.global_step, rolled_back_from=rolled_back_from,
                    restore_seconds=round(restore_s, 6))
        ptlog.error("rolled back to checkpoint step %d (rollback %d this run)",
                    self.global_step, self.rollbacks)

    # -- preemption ---------------------------------------------------------
    def _install_preemption_handlers(self):
        """Catch SIGTERM (the cluster-preemption signal) during the loop;
        the actual save happens at the next step boundary, where params are
        a consistent, fully-materialized tree. Main thread only — signal
        handlers cannot be installed elsewhere."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def on_signal(signum, frame):
            self._preempt_requested = True
            ptlog.vlog(0, "signal %d: checkpoint at next step boundary", signum)

        prev = {}
        for sig in (signal.SIGTERM,):
            try:
                prev[sig] = signal.signal(sig, on_signal)
            except (ValueError, OSError):  # non-main interpreter contexts
                pass
        return prev

    def _restore_signal_handlers(self, prev):
        if not prev:
            return
        for sig, old in prev.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass

    def _preemption_save(self, next_epoch: int):
        """Emergency save on preemption. ``next_epoch`` is the epoch resume
        should start at: the interrupted epoch for a mid-epoch save (it
        restarts, matching the reference's mid-epoch checkpoint semantics),
        epoch+1 when the signal landed on a completed epoch boundary."""
        self.preempted = True
        if self.checkpoint_cfg is not None and self.checkpoint_cfg.async_save:
            # an async save may be in flight or may have FAILED — "already
            # saved" is only true once the publish is confirmed durable
            try:
                cks.wait_pending_save()
            except Exception as e:
                ptlog.warning("pending async checkpoint failed (%s); re-saving", e)
                self._last_saved_step = -1
        if self.checkpoint_cfg is not None and self.global_step != self._last_saved_step:
            self._save_checkpoint({"next_epoch": next_epoch, "preempted": True})
            ptlog.vlog(0, "preempted: saved at epoch %d step %d", self.epoch, self.global_step)
        else:
            ptlog.vlog(
                0, "preempted at epoch %d step %d (no new checkpoint: %s)",
                self.epoch, self.global_step,
                "none configured" if self.checkpoint_cfg is None else "state already saved",
            )

    def _batches(self, reader):
        """One epoch's batch stream, optionally device-prefetched: copies to
        the card run on a producer thread ``prefetch_depth`` batches ahead,
        so the step never waits on host->device copies (in parallel mode
        the whole global batch; the step takes this rank's rows of it)."""
        it = iter(reader())
        if self.prefetch:
            from paddle_tpu_torch.reader import DevicePrefetcher

            it = DevicePrefetcher(it, device=self.exe.device)
        for batch in it:
            # fault point: reader-side IO errors / stalls surface here, on
            # the consuming thread (the prefetcher's producer re-raises too)
            faults.inject(faults.READER_NEXT, epoch=self.epoch, step=self.global_step)
            yield batch

    def _run_step(self, batch) -> StepOutput:
        """One step: the batch's copy to the card (``trainer.h2d``; in
        parallel mode ``put_batch`` takes this rank's rows) and the step
        (``trainer.step_compute``). The first step runs under the cost
        counter, which fixes ``_step_flops`` for MFU."""
        if self.parallel:
            ragged = self._allow_ragged and not self._dp.batch_divisible(*batch)
            with tracing.start_span("trainer.h2d"):
                args = tuple(batch) if ragged else self._dp.put_batch(*batch)
            step_fn = self._dp.step_ragged if ragged else self._dp.step
        else:
            step_fn = self._compiled_step()
            with tracing.start_span("trainer.h2d"):
                args = self.exe.put(tuple(batch))
        with tracing.start_span("trainer.step_compute"), \
                prof.record_event("trainer.step_compute"):
            if self._step_flops is not None:
                return step_fn(self.variables, self.opt_state, *args)
            with obs_mfu.CostCounter() as counter:
                out = step_fn(self.variables, self.opt_state, *args)
            self._step_flops = float(counter.flops)
            return out

    def _maybe_checkpoint(self, epoch_id: int, step: bool):
        cfg = self.checkpoint_cfg
        if cfg is None or self.variables is None:
            return
        due = (
            self.global_step % cfg.step_interval == 0
            if step
            else (epoch_id + 1) % cfg.epoch_interval == 0
        )
        if not due:
            return
        # if a step save already captured this state, don't save a duplicate
        # serial — but an epoch boundary must still bump next_epoch in the
        # metadata so resume skips the completed epoch
        if self.global_step == self._last_saved_step:
            if not step:
                if cfg.use_sharded():
                    cks.update_manifest(cfg.checkpoint_dir, {"next_epoch": self.epoch + 1})
                elif mesh_mod.process_rank() == 0:
                    ckpt_mod.update_meta(cfg.checkpoint_dir, {"next_epoch": self.epoch + 1})
            return
        self._save_checkpoint({"next_epoch": self.epoch + (0 if step else 1)})

    def _save_checkpoint(self, extra_meta: dict):
        """Shared sharded/single-file checkpoint dispatch. In parallel mode
        every rank calls it: a sharded save writes each rank's blocks; a
        single-file save is written by rank 0 alone, after ZeRO-1's slots
        are gathered whole."""
        cfg = self.checkpoint_cfg
        tree = (self.variables, self.opt_state)
        if cfg.use_sharded():
            save = cks.save_sharded_async if cfg.async_save else cks.save_sharded
            save(
                cfg.checkpoint_dir, tree,
                step=self.global_step,
                epoch=self.epoch,
                max_num_checkpoints=cfg.max_num_checkpoints,
                extra_meta=extra_meta,
                template=self._dp.state_template(*tree) if self._dp is not None else None,
            )
        else:
            if self._dp is not None:
                tree = self._dp.full_state(*tree)
            if mesh_mod.process_rank() == 0:
                ckpt_mod.save_checkpoint(
                    cfg.checkpoint_dir, tree,
                    step=self.global_step,
                    epoch=self.epoch,
                    max_num_checkpoints=cfg.max_num_checkpoints,
                    trainer_id=self.trainer_id,
                    extra_meta=extra_meta,
                )
            mesh_mod.barrier()  # published before any rank may read it
        self._last_saved_step = self.global_step

    # -- eval / predict -----------------------------------------------------
    def test(self, reader: Callable[[], Iterable[Tuple]], loss_index: int = 0):
        """Average loss over a reader (reference Trainer.test,
        trainer.py:438)."""
        enforce(self.variables is not None, "train (or init) before test")
        losses = []
        with torch.no_grad():
            for batch in reader():
                out, _ = self.model.apply(self.variables, *self.exe.put(tuple(batch)),
                                          is_train=False)
                loss = out[loss_index] if isinstance(out, (tuple, list)) else out
                losses.append(float(torch.mean(loss.float())))
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate(self, reader: Callable[[], Iterable[Tuple]], metric_fn,
                 pad_to_first: bool = True):
        """Exact test-set metric: every sample counts exactly once,
        including a ragged final batch. In parallel mode the batch is padded
        to the shard multiple (``DataParallel.pad_batch``), each rank
        evaluates its rows, the validity mask zeroes the padding out, and
        the metric's sum and count are summed over the ranks — the
        reference's data_balance guarantee
        (``details/data_balance_op_handle.cc:154``).

        ``metric_fn(outputs, *batch) -> [B]`` per-sample values (e.g. a
        correct-prediction indicator), given the model's outputs and the
        rows of the reader's batch they belong to; returns their mean over
        all samples. ``pad_to_first`` pads every ragged batch to the first
        batch's size."""
        enforce(self.variables is not None, "train (or init) before evaluate")
        total, count = 0.0, 0
        target = None
        with torch.no_grad():
            for batch in reader():
                n = int(np.shape(batch[0])[0])
                if self.parallel:
                    # a batch LARGER than the latched first-batch size pads
                    # to its own multiple
                    to = target if (target is not None and n <= target) else None
                    padded, mask = self._dp.pad_batch(*batch, to=to)
                    if target is None and pad_to_first:
                        target = mask.shape[0]
                    rows = tuple(self._dp.rank_rows(b) for b in padded)
                    mask = self._dp.rank_rows(mask)
                    out = self._dp.eval_local(self.variables, *self._dp.put_batch(*padded))
                else:
                    rows, mask = batch, np.ones((n,), np.float32)
                    out, _ = self.model.apply(self.variables, *self.exe.put(tuple(batch)),
                                              is_train=False)
                per_sample = metric_fn(out, *rows)
                if isinstance(per_sample, torch.Tensor):
                    per_sample = per_sample.detach().cpu().numpy()
                per_sample = np.asarray(per_sample, np.float64)
                # exact shape: a [B, 1] column would broadcast against the
                # [B] mask into [B, B] and silently inflate the metric
                enforce(
                    per_sample.shape == mask.shape,
                    f"metric_fn must return one value per row (shape "
                    f"{mask.shape}), got shape {per_sample.shape}",
                )
                total += float((per_sample * mask).sum())
                count += int(mask.sum())
        if self.parallel:
            total, count = self._dp.sum_over_ranks([total, count])
            count = int(count)
        return total / count if count else float("nan")

    def save_params(self, dirname: str):
        """Persist current parameters (reference save_params, io.py:89)."""
        from paddle_tpu_torch import io as io_mod

        enforce(self.variables is not None, "nothing to save: model not initialized")
        io_mod.save_params(dirname, self.variables)

    def stop(self):
        # detach OUR snapshot listener (== not `is`: bound methods are
        # recreated per access) so a later trainer's saves don't feed a
        # dead supervisor
        if self._elastic is not None and cks._snapshot_listener == self._elastic.note_snapshot:
            cks.set_snapshot_listener(None)
        try:
            cks.wait_pending_save()  # the last async checkpoint must be durable
        finally:
            self.exe.close()  # a failed writer must not leak the executor
            if self._watcher is not None:
                self._watcher.close()  # stop watching the registry's writes
                self._watcher = None
