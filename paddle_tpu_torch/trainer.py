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

Not ported yet (each raises ``NotImplementedError`` naming
``ROADMAP.md``): elastic training (``ResilienceConfig(elastic=True)``)
and the telemetry hooks (``observability=``, ``watch=``; goodput, MFU,
trace spans, the straggler detector). ``_record_step`` keeps the step-time
counters of :mod:`paddle_tpu_torch.core.profiler` and the run log.
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
from paddle_tpu_torch.checkpoint import CheckpointConfig
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.framework import Model, Variables, build
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.optimizer import Optimizer, OptState, StepOutput
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.resilience import ResilienceConfig, faults
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"Trainer({what}) is not ported to paddle_tpu_torch yet; see ROADMAP.md")


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
        observability: Optional[Any] = None,
        watch: Optional[Any] = None,
    ):
        if observability is not None or watch is not None:
            raise _not_ported("observability=/watch=: the telemetry stack")
        self.resilience = resilience if resilience is not None else ResilienceConfig.from_flags()
        if self.resilience.elastic:
            raise _not_ported("resilience=ResilienceConfig(elastic=True): elastic training")
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
        self._ema_eps: Optional[float] = None  # EMA examples/sec

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
            self.variables, self.opt_state = self._dp.init(self.rng, *first_batch)
        else:
            self.variables = self.model.init(self.rng, *self.exe.put(tuple(first_batch)),
                                             device=self.exe.device)
            self.opt_state = self.optimizer.create_state(self.variables.params)
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
        prev_handlers = self._install_preemption_handlers()
        res = self.resilience
        if res.stall_timeout_s is not None and self._watchdog is None:
            self._watchdog = StepWatchdog(res.stall_timeout_s)
        try:
            for epoch_id in range(self.epoch, num_epochs):
                self.epoch = epoch_id
                handler(BeginEpochEvent(epoch_id))
                for step_id, batch in enumerate(self._batches(reader)):
                    begin_ev = BeginStepEvent(epoch_id, step_id)
                    handler(begin_ev)
                    # fault point: "error" raises here (a crashing step),
                    # "nan" forces this step to count as non-finite,
                    # "preempt" delivers SIGTERM (handled at the boundary below)
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
                        self._record_step(epoch_id, batch, time.perf_counter() - t_step, metrics)
                    # the step's outputs (an LM's logits) must not live
                    # through the next step
                    del out
                    handler(EndStepEvent(epoch_id, step_id, metrics))
                    if self._preempt_requested:
                        self._preemption_save(next_epoch=epoch_id)
                        return
                    self._maybe_checkpoint(epoch_id, step=True)
                handler(EndEpochEvent(epoch_id))
                self._maybe_checkpoint(epoch_id, step=False)
                if self._preempt_requested:
                    # the epoch just COMPLETED — resume must not re-train it
                    self._preemption_save(next_epoch=epoch_id + 1)
                    return
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

    # -- telemetry ----------------------------------------------------------
    def _record_step(self, epoch_id: int, batch, dt: float, loss: Optional[float]) -> None:
        """Registry + runlog record for one GOOD step: step-time histogram
        and throughput gauges (instant + EMA)."""
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
        runlog.emit(
            "step", step=self.global_step, epoch=epoch_id, loss=loss,
            step_time_s=round(dt, 6), examples_per_sec=round(eps, 3),
            ema_examples_per_sec=round(self._ema_eps, 3))

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
        runlog.emit("rollback", step=self.global_step, rolled_back_from=rolled_back_from,
                    restore_seconds=round(time.perf_counter() - t0, 6))
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
        if self.parallel:
            with prof.record_event("trainer.step_compute"):
                if self._allow_ragged and not self._dp.batch_divisible(*batch):
                    return self._dp.step_ragged(self.variables, self.opt_state, *batch)
                return self._dp.step(self.variables, self.opt_state, *batch)
        step_fn = self._compiled_step()
        args = self.exe.put(tuple(batch))
        with prof.record_event("trainer.step_compute"):
            return step_fn(self.variables, self.opt_state, *args)

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
        try:
            cks.wait_pending_save()  # the last async checkpoint must be durable
        finally:
            self.exe.close()  # a failed writer must not leak the executor
