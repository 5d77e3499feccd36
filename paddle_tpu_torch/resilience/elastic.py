"""Elastic training: survive the loss of a rank by re-forming the process
group over the survivors, regrow later — port of
``paddle_tpu/resilience/elastic.py``.

The reference framework's multi-device story was a FIXED world: a
ParallelExecutor over an NCCL clique whose membership was decided at build
time (``platform/nccl_helper.h:81-126``) — one dead rank wedged the
allreduce ring until an operator restarted the job. Here a lost rank is a
schedulable event. The "devices" of the JAX package's supervisor are ranks:
a lost device's index is the rank's index in the initial world
(:func:`~paddle_tpu_torch.parallel.mesh.initial_rank`).

1. **Detect** — a classified :class:`~paddle_tpu_torch.resilience.faults.
   DeviceLostError` out of the step (injectable at ``faults.DEVICE_LOST``
   for deterministic CPU tests), a transport error of the collectives
   (:func:`is_device_loss`: gloo's closed or reset connection to a peer,
   NCCL's aborted communicator or watchdog timeout, any
   ``DistBackendError``), or an escalation: ``elastic_escalate_stalls``
   consecutive watchdog stalls trigger a liveness probe.
2. **Agree + re-form** — a process group cannot drop a member in place, so
   every survivor leaves it and joins the next generation
   (:func:`~paddle_tpu_torch.parallel.mesh.reform`), the survivors in the
   order of their old ranks; ``DataParallel.resize`` rebuilds the mesh
   and its axis groups over the new world (the batch axis absorbs the
   change, the other axes keep their sizes).
3. **Restore** — the last published serial (``latest_sharded_checkpoint``)
   through ``load_sharded``, each rank reading its window of the new
   world's layout (``DataParallel.state_template``): the shrink IS a
   resharded restore. A serial the lost generation left half-written is
   never published (it stays ``checkpoint_<s>.tmp``), so it is neither
   read nor in the way: the next save of that step clears it.
4. **Resume** — the interrupted epoch replays from the restored step; a
   global batch that no longer divides the world trains through
   ``step_ragged``.
5. **Regrow** — at a checkpoint boundary (state durable there), a rank
   that came back and registered at the next generation's rendezvous
   (:func:`~paddle_tpu_torch.parallel.mesh.join_generation`) is taken in:
   the survivors re-form with it, re-place their state on the grown mesh
   (``DataParallel.place_state``), and hand it the training position; it
   loads the boundary's checkpoint. A regrow that fails costs nothing but
   the attempt.

A scheduler's advance warning rides ``faults.PREEMPT_NOTICE`` -> SIGTERM
-> the Trainer's existing boundary save, so a rescheduled job auto-resumes
through ``Trainer.__init__``.

Two differences from the JAX supervisor, both forced by one process per
rank:

- **The restore reads the disk.** A shrink starts from two or more
  ranks, whose saves are synchronous and call no snapshot listener
  (``checkpoint_sharded.save_sharded_async``), so ``last_recovery["source"]``
  is ``"disk"`` where the JAX supervisor's single-process run reads
  ``"snapshot"``. :meth:`ElasticSupervisor.note_snapshot` still receives a
  one-rank world's snapshots, as the JAX supervisor's does, but a snapshot
  is never a recovery source across processes. Restoring from the
  survivors' own memory is not done either: a survivor holds neither the
  lost rank's ZeRO-1 rows nor its stored blocks, so that state would be
  incomplete.
- **Attribution.** Which ranks a loss took comes from the error's
  ``device_indices``, else the ``probe``, else the next generation's
  rendezvous, where each survivor registers its old rank: the member set
  closes when every old rank has registered or been attributed as lost,
  or at a deadline taken from the collective timeout. The JAX fallback
  ("the highest-index survivor") is not used: in one process it is a
  harmless guess, but across processes it would evict a live rank, which
  would then wait forever.

Telemetry: ``elastic.shrinks_total`` / ``elastic.regrows_total`` counters,
``elastic.devices`` gauge, ``elastic.recovery_seconds`` histogram, runlog
``elastic_shrink`` / ``elastic_regrow`` events (inside a
``trainer.elastic_recover`` trace, so they carry trace ids), and the
recovery wall time lands in GoodputTracker badput as ``elastic_recovery``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence

import torch.distributed as dist

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.resilience.faults import DeviceLostError

__all__ = ["ElasticSupervisor", "DeviceLostError", "is_device_loss"]

# lowercase substrings of runtime-error text that mean "a device or a peer
# died": the JAX package's PJRT/XLA markers, gloo's texts for a peer whose
# process ended (its socket closed or reset), and NCCL's for a communicator
# aborted after a collective timed out
_LOSS_MARKERS = (
    "data_loss", "device halted", "hardware failure", "device lost",
    "connection closed by peer", "connection reset by peer",
    "communicator was aborted", "watchdog caught collective operation timeout",
)


def is_device_loss(exc: BaseException) -> bool:
    """Classify an exception as a recoverable loss of a rank. Explicit
    :class:`DeviceLostError` and the backend's ``DistBackendError`` always
    are; other RuntimeErrors match on the known loss markers. Anything
    else (an ordinary step error) stays fatal."""
    if isinstance(exc, DeviceLostError):
        return True
    backend_error = getattr(dist, "DistBackendError", None)
    if backend_error is not None and isinstance(exc, backend_error):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        return any(m in msg for m in _LOSS_MARKERS)
    return False


class ElasticSupervisor:
    """Rank-loss bookkeeping + the shrink/regrow recovery procedure.

    Owned by a :class:`~paddle_tpu_torch.trainer.Trainer` when
    ``ResilienceConfig(elastic=True)`` (requires ``parallel=True`` and a
    sharded checkpoint config). ``devices`` is the initial world's ranks;
    lost ones are tracked as indices into it. ``probe`` is an optional
    zero-arg callable returning the indices currently alive — a cluster
    launcher wires its health endpoint here (the Trainer wires
    :func:`~paddle_tpu_torch.parallel.launch.health_probe` under
    ``launch.spawn``); tests wire a lambda. Without a probe, stall
    escalation is inert, and a loss no error attributes closes the
    rendezvous at its deadline.
    """

    def __init__(self, config, devices: Sequence,
                 probe: Optional[Callable[[], Iterable[int]]] = None):
        enforce(bool(devices), "ElasticSupervisor needs the initial device list")
        self.config = config
        self.all_devices = list(devices)
        self.probe = probe
        self.lost: set = set()
        self.shrinks = 0
        self.regrows = 0
        # freshest (shard_data, manifest) captured by a single-rank save;
        # never a recovery source (the module docstring says why)
        self._snapshot = None
        self._stall_count = 0
        # summary of the most recent recovery / regrow (tests, chip_smoke)
        self.last_recovery: Optional[dict] = None
        self.last_regrow: Optional[dict] = None

    # -- snapshot feed (checkpoint_sharded.set_snapshot_listener) -----------
    def note_snapshot(self, shard_data, manifest) -> None:
        self._snapshot = (shard_data, manifest)

    # -- stall escalation (trainer._on_stall -> here) -----------------------
    def note_stall(self) -> None:
        self._stall_count += 1

    def escalation_due(self) -> bool:
        return (
            self.probe is not None
            and self._stall_count >= self.config.elastic_escalate_stalls
        )

    def escalate(self) -> Optional[DeviceLostError]:
        """Stalls crossed the threshold: probe liveness. Returns a
        :class:`DeviceLostError` naming newly-dead ranks for the caller to
        recover from, or None when everything (still tracked as alive)
        responds — either way the stall counter resets, so a fresh burst of
        stalls is needed to probe again."""
        self._stall_count = 0
        if self.probe is None:
            return None
        alive = set(self.probe())
        dead = [
            i for i in range(len(self.all_devices))
            if i not in alive and i not in self.lost
        ]
        if not dead:
            return None
        ptlog.error("elastic probe after stalls: ranks %s unresponsive", dead)
        return DeviceLostError(
            f"probe after repeated stalls: ranks {dead} unresponsive",
            device_indices=dead,
        )

    # -- device accounting --------------------------------------------------
    def usable_devices(self):
        return [d for i, d in enumerate(self.all_devices) if i not in self.lost]

    def _attribute_loss(self, error: BaseException):
        """Which ranks did this loss take, as far as is known before the
        rendezvous? The error's own attribution, then a probe; with
        neither, none: the next generation's rendezvous attributes the
        ranks that never register (see the module docstring)."""
        idx = getattr(error, "device_indices", ())
        if idx:
            return [i for i in idx if i not in self.lost]
        if self.probe is not None:
            alive = set(self.probe())
            return [i for i in range(len(self.all_devices))
                    if i not in alive and i not in self.lost]
        return []

    def _restore(self, trainer):
        """The training state at the new world's layout: the last
        published serial, from disk."""
        from paddle_tpu_torch import checkpoint_sharded as cks

        template = trainer._dp.state_template(trainer.variables, trainer.opt_state)
        root = trainer.checkpoint_cfg.checkpoint_dir
        enforce(cks.latest_sharded_checkpoint(root) is not None,
                f"elastic recovery: no published checkpoint under {root}")
        return cks.load_sharded(root, template)

    # -- shrink -------------------------------------------------------------
    def recover(self, trainer, error: BaseException) -> None:
        """The shrink path: quiesce, re-form the process group over the
        survivors and rebuild the mesh, restore the last durable state at
        the new world size, and point the trainer at the restored
        step/epoch. Raises :class:`~paddle_tpu_torch.parallel.mesh.
        EvictedError` on a rank the loss took (it leaves), and
        ``EnforceError`` naming ``elastic`` when fewer than
        ``elastic_min_devices`` survive — elastic gives up and the
        original loss becomes fatal."""
        from paddle_tpu_torch import checkpoint_sharded as cks
        from paddle_tpu_torch import tracing
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        t0 = time.perf_counter()
        detected_at = time.time()
        with tracing.start_trace("trainer.elastic_recover") as span:
            # quiesce: the step loop already stopped; drain an in-flight
            # async save (single rank) so its serial is the freshest state
            try:
                cks.wait_pending_save()
            except Exception as e:
                ptlog.warning("async save failed during elastic recovery: %s", e)

            dead = self._attribute_loss(error)
            before = int(trainer._dp.num_devices)
            form = mesh_mod.reform(dead, probe=self.probe,
                                   min_members=self.config.elastic_min_devices)
            self.lost = set(range(len(self.all_devices))) - set(form["members"])
            t_formed = time.perf_counter()
            trainer._dp.resize(range(len(form["members"])))
            t_meshed = time.perf_counter()
            (trainer.variables, trainer.opt_state), manifest = self._restore(trainer)
            source = "disk"
            restored_step = int(manifest.get("step", trainer.global_step))
            trainer.global_step = restored_step
            trainer.epoch = int(manifest.get("next_epoch", manifest.get("epoch", trainer.epoch)))
            trainer._last_saved_step = restored_step
            # the global batch may no longer divide the shrunken world;
            # ragged batches train through the existing step_ragged path
            trainer._allow_ragged = True
            trainer._step_flops = None  # re-count the step's FLOPs on the new world
            trainer._consec_bad = 0
            self._stall_count = 0
            self.shrinks += 1

            devices = len(form["members"])
            recovery_s = time.perf_counter() - t0
            self.last_recovery = {
                "restored_step": restored_step,
                "devices": devices,
                "members": form["members"],
                "source": source,
                "seconds": recovery_s,
                "detected_at": detected_at,
                "leave_s": form["leave_s"],
                "rendezvous_s": form["rendezvous_s"],
                "join_s": form["join_s"],
                "remesh_s": t_meshed - t_formed,
                "restore_s": time.perf_counter() - t_meshed,
                "generation": form["generation"],
            }
            span.set(devices_before=before, devices_after=devices,
                     restored_step=restored_step, source=source)
            prof.inc_counter("elastic.shrinks_total")
            prof.set_gauge("elastic.devices", devices)
            prof.observe("elastic.recovery_seconds", recovery_s)
            trainer.goodput.record_bad(recovery_s, "elastic_recovery")
            prof.set_gauge("trainer.goodput_frac", trainer.goodput.goodput_frac())
            runlog.emit(
                "elastic_shrink", step=restored_step,
                devices_before=before, devices_after=devices,
                source=source, cause=str(error)[:500], seconds=round(recovery_s, 6),
            )
            ptlog.error(
                "elastic shrink: %d -> %d ranks, resumed from step %d (%s) after: %s",
                before, devices, restored_step, source, error,
            )

    # -- regrow -------------------------------------------------------------
    def _returned(self, trainer) -> list:
        """The lost ranks waiting at the next generation's rendezvous (and
        alive by the probe, when there is one), as the current group's
        first rank sees them: one broadcast, so every member decides
        alike."""
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        seen = [None]
        if mesh_mod.process_rank() == 0:
            back = mesh_mod.registered(mesh_mod.generation() + 1, sorted(self.lost))
            if self.probe is not None:
                alive = set(self.probe())
                back = [i for i in back if i in alive]
            seen = [back]
        if mesh_mod.world_size() > 1:
            dist.broadcast_object_list(seen, src=0)
        return list(seen[0])

    def maybe_regrow(self, trainer) -> bool:
        """At a checkpoint boundary (state durable — the only place a
        failed regrow costs nothing), take in the lost ranks that came
        back: re-form the group with them, rebuild the mesh, re-place the
        state on it and hand them the training position
        (:meth:`position`). Returns True when the world grew. Collective:
        every member calls it at the same boundary."""
        if not self.config.elastic_regrow or not self.lost:
            return False
        if trainer.global_step != trainer._last_saved_step:
            return False  # not at a checkpoint boundary
        returned = self._returned(trainer)
        if not returned:
            return False
        from paddle_tpu_torch import checkpoint_sharded as cks
        from paddle_tpu_torch import tracing
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        # a one-rank world saves in the background: the returning rank
        # loads this boundary's serial, so it must be published first
        # (several ranks save synchronously: nothing is pending there)
        try:
            cks.wait_pending_save()
        except Exception as e:
            ptlog.warning("elastic regrow skipped: the boundary's save failed: %s", e)
            return False
        t0 = time.perf_counter()
        with tracing.start_span("trainer.elastic_regrow"):
            before = int(trainer._dp.num_devices)
            # whole state in the old group (ZeRO-1 rows, stored blocks),
            # re-placed on the grown mesh below
            whole = trainer._dp.full_state(trainer.variables, trainer.opt_state)
            form = mesh_mod.reform(include=returned)
            self.lost = set(range(len(self.all_devices))) - set(form["members"])
            self.regrows += 1
            trainer._dp.resize(range(len(form["members"])))
            position = [self.position(trainer)]
            dist.broadcast_object_list(position, src=form["members"].index(form["source"]))
            trainer.variables, trainer.opt_state = trainer._dp.place_state(*whole)
            trainer._step_flops = None
            devices = len(form["members"])
            regrow_s = time.perf_counter() - t0
            self.last_regrow = {"step": trainer.global_step, "devices": devices,
                                "members": form["members"], "seconds": regrow_s,
                                "rendezvous_s": form["rendezvous_s"]}
            prof.inc_counter("elastic.regrows_total")
            prof.set_gauge("elastic.devices", devices)
            runlog.emit(
                "elastic_regrow", step=trainer.global_step,
                devices_before=before, devices_after=devices,
                seconds=round(regrow_s, 6),
            )
            ptlog.vlog(
                0, "elastic regrow: %d -> %d ranks at step %d",
                before, devices, trainer.global_step,
            )
        return True

    def position(self, trainer) -> dict:
        """What a returning rank needs to step in lockstep with the
        survivors: where the epoch stands (the step just taken in it) and
        what the supervisor knows."""
        return {"epoch": trainer.epoch, "step_id": trainer._step_in_epoch,
                "global_step": trainer.global_step,
                "lost": sorted(self.lost), "shrinks": self.shrinks, "regrows": self.regrows,
                "allow_ragged": trainer._allow_ragged}

    def adopt(self, position: dict) -> None:
        """A returning rank takes the survivors' bookkeeping."""
        self.lost = set(position["lost"])
        self.shrinks, self.regrows = int(position["shrinks"]), int(position["regrows"])
