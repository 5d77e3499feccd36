"""paddle_tpu_torch.resilience — fault injection, self-healing, circuit breaking.

Copies of ``paddle_tpu.resilience`` (jax-free):

- :mod:`resilience.faults` — named injection points (checkpoint save/load,
  reader iteration, trainer step) driven by seeded :class:`FaultSpec`
  schedules;
- :class:`ResilienceConfig` — the Trainer's self-healing policy: what to
  do with a NaN/Inf step (``raise`` | ``skip_step`` | ``rollback``), when
  to roll back, and the step-stall watchdog timeout;
- :mod:`resilience.watchdog` — :class:`StepWatchdog` dumps all-thread
  stacks when a step exceeds its stall budget;
- :mod:`resilience.integrity` — CRC32 + fsync + quarantine helpers backing
  the checkpoint module's corrupt-serial fallback;
- :mod:`resilience.circuit` — the :class:`CircuitBreaker` serving uses;
- :mod:`resilience.elastic` — :class:`ElasticSupervisor`: a Trainer with
  ``ResilienceConfig(elastic=True)`` survives a lost rank by re-forming the
  process group over the survivors and restoring the last checkpoint at
  the new world size, and regrows at a checkpoint boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.circuit import CircuitBreaker
from paddle_tpu_torch.resilience.faults import FaultPlan, FaultSpec, injected
from paddle_tpu_torch.resilience.integrity import CheckpointCorruptError
from paddle_tpu_torch.resilience.watchdog import StepWatchdog

__all__ = [
    "ResilienceConfig",
    "FaultSpec",
    "FaultPlan",
    "injected",
    "faults",
    "CircuitBreaker",
    "StepWatchdog",
    "CheckpointCorruptError",
    "NAN_POLICIES",
]

NAN_POLICIES = ("raise", "skip_step", "rollback")


@dataclasses.dataclass
class ResilienceConfig:
    """Self-healing policy for :class:`paddle_tpu_torch.trainer.Trainer`.

    ``nan_policy`` decides what a non-finite step (loss/gradients, detected
    by the in-step ``check_nan_inf`` flag or injected via
    ``faults.TRAINER_STEP``) does:

    - ``"raise"``     — fatal;
    - ``"skip_step"`` — drop the bad update (params/opt state keep their
      pre-step values), count it, continue;
    - ``"rollback"``  — skip, and after ``rollback_after`` CONSECUTIVE bad
      steps restore params + optimizer state from the last good checkpoint
      (requires a ``checkpoint_config``); after ``max_rollbacks`` restores
      without a good step in between, give up and raise.

    ``stall_timeout_s`` arms a :class:`StepWatchdog` around every training
    step; a step exceeding it gets an all-thread stack dump in the log
    (diagnostics only — the step is never killed directly; with elastic
    training on, repeated stalls escalate to a liveness probe, see below).

    Elastic training (``elastic=True``, requires ``parallel=True`` and a
    sharded checkpoint config): an :class:`~paddle_tpu_torch.resilience.
    elastic.ElasticSupervisor` catches the loss of a rank
    (``faults.DeviceLostError`` / a transport error of the collectives),
    re-forms the process group over the surviving ranks (never fewer than
    ``elastic_min_devices``), restores the last good serial at the new
    world size and resumes. ``elastic_regrow`` re-expands the world at a
    checkpoint boundary when a lost rank returns (it registers at the next
    generation's rendezvous). ``elastic_escalate_stalls`` watchdog stalls
    without a good step trigger a liveness probe (stall -> suspected loss
    escalation). All four are env-settable: ``PADDLE_TPU_ELASTIC=1``,
    ``PADDLE_TPU_ELASTIC_MIN_DEVICES``, ``PADDLE_TPU_ELASTIC_REGROW``,
    ``PADDLE_TPU_ELASTIC_ESCALATE_STALLS``.
    """

    nan_policy: str = "raise"
    rollback_after: int = 3
    max_rollbacks: int = 2
    stall_timeout_s: Optional[float] = None
    elastic: bool = False
    elastic_min_devices: int = 1
    elastic_regrow: bool = True
    elastic_escalate_stalls: int = 2

    def __post_init__(self):
        from paddle_tpu_torch.core.enforce import enforce, enforce_in

        enforce_in(self.nan_policy, NAN_POLICIES, "nan_policy")
        enforce(self.rollback_after >= 1,
                f"rollback_after must be >= 1, got {self.rollback_after}")
        enforce(self.max_rollbacks >= 0,
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}")
        enforce(
            self.stall_timeout_s is None or self.stall_timeout_s > 0,
            f"stall_timeout_s must be positive, got {self.stall_timeout_s}",
        )
        enforce(self.elastic_min_devices >= 1,
                f"elastic_min_devices must be >= 1, got {self.elastic_min_devices}")
        enforce(self.elastic_escalate_stalls >= 1,
                f"elastic_escalate_stalls must be >= 1, got {self.elastic_escalate_stalls}")

    @classmethod
    def from_flags(cls) -> "ResilienceConfig":
        """Default policy from the global flags (env-settable:
        ``PADDLE_TPU_CHECK_NAN_INF_POLICY=skip_step``,
        ``PADDLE_TPU_NAN_ROLLBACK_AFTER``, ``PADDLE_TPU_ELASTIC=1`` etc.)."""
        from paddle_tpu_torch.core import config as cfg

        f = cfg.flags()
        return cls(
            nan_policy=f.check_nan_inf_policy,
            rollback_after=f.nan_rollback_after,
            elastic=f.elastic,
            elastic_min_devices=f.elastic_min_devices,
            elastic_regrow=f.elastic_regrow,
            elastic_escalate_stalls=f.elastic_escalate_stalls,
        )

