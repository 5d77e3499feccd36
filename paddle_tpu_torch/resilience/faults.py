"""Deterministic fault injection: named points, seeded schedules.

The reference framework's robustness machinery (per-op
``FLAGS_check_nan_inf`` in ``operator.cc:725-737``, the Go pserver's
CRC-checked checkpoints, the trainer's ExceptionHolder) was tested by
real clusters failing. This reproduction tests it on purpose: production
code calls :func:`inject` at a handful of named points, and a test (or
``tools/chaos_smoke.py``) installs a :class:`FaultSpec` schedule that
makes exactly the chosen hits fail — IO errors, NaN gradients, stalls,
simulated preemption — so every recovery path is exercised determin-
istically under tier-1.

With no plan installed, :func:`inject` is a single global ``is None``
check — zero overhead on production hot paths.

Fault kinds:

- ``"error"``  — raise ``spec.exc`` (default ``OSError``) at the point;
- ``"nan"``    — return the spec; the call site poisons its own numerics
  (the trainer treats the step's gradients as non-finite);
- ``"stall"``  — sleep ``spec.stall_s`` then return the spec (exercises
  the step watchdog);
- ``"preempt"``— deliver SIGTERM to this process (the cluster-preemption
  signal the Trainer already catches at step boundaries).

Scheduling: a spec fires on hit numbers ``after .. after+times-1`` of its
point (per-spec hit counter), or — when ``p`` is set — on each hit with
probability ``p`` drawn from the PLAN's seeded rng, so a whole chaos
schedule replays identically for a given seed.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce, enforce_in
from paddle_tpu_torch.observability import runlog

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "install",
    "clear",
    "injected",
    "inject",
    "active_plan",
    "stats",
    "CHECKPOINT_SAVE",
    "CHECKPOINT_LOAD",
    "READER_NEXT",
    "TRAINER_STEP",
    "SERVING_DISPATCH",
    "DECODE_STEP",
    "DECODE_RECOVER",
    "DISAGG_HANDOFF",
    "HOST_TIER",
    "GROUP_MEMBER",
    "DEVICE_LOST",
    "PREEMPT_NOTICE",
    "DeviceLostError",
    "registered_points",
]

# the named injection points wired into the framework
CHECKPOINT_SAVE = "checkpoint.save"
CHECKPOINT_LOAD = "checkpoint.load"
READER_NEXT = "reader.next"
TRAINER_STEP = "trainer.step"
SERVING_DISPATCH = "serving.dispatch"
# continuous-batching decode loop (serving.decode.DecodeEngine): fires
# around the jitted decode step, so chaos runs can fail one iteration and
# assert the loop keeps serving the surviving requests
DECODE_STEP = "serving.decode.step"
# the recovery path itself (quarantine + re-admission after a failed decode
# iteration): failing *here* proves recovery is not a single point of
# failure — a fault during recovery escalates to migration/journal replay
DECODE_RECOVER = "serving.decode.recover"
# disaggregated prefill/decode handoff (serving.disagg.DisaggRouter):
# fires on the transfer path between a prefill worker publishing a
# request's KV pages and the decode worker adopting them — a fault here
# models a torn/failed transfer, which must degrade to re-prefill on
# another worker (never a lost request)
DISAGG_HANDOFF = "serving.disagg.handoff"
# hierarchical KV host tier (serving.host_tier.HostPagePool): fires on
# the promote path (ctx op="promote" — a "nan" spec corrupts the fetched
# page bytes BEFORE CRC verification, so a bit-flipped host page must be
# quarantined and the request re-prefilled token-exactly) and on the
# demote path (ctx op="demote" — a "stall" models slow host memory and
# must never extend the pool's lock hold or stall the decode loop's
# step path beyond the stalled iteration)
HOST_TIER = "serving.host_tier"
# per-member canary of a tensor-parallel replica group
# (serving.shardgroup.probe_members): fires once per shard with
# ctx={engine, shard, device}, so chaos can fail or stall exactly ONE chip
# of a group — an "error" here must eject the WHOLE group (breaker trip +
# zero-loss migration) and a "stall" must be localized by the shard-skew
# straggler watch
GROUP_MEMBER = "serving.group.member"
# elastic-training points (trainer step loop): a replica/device vanishing
# mid-step, and the scheduler's advance preemption notice — both are
# hardware/cluster events in production, injectable here so the whole
# shrink/drain path is deterministically testable on CPU
DEVICE_LOST = "device.lost"
PREEMPT_NOTICE = "preempt.notice"

_KINDS = ("error", "nan", "stall", "preempt")


def registered_points() -> List[str]:
    """Every named injection point wired into the framework, in
    declaration order. ``tools/chaos_smoke.py`` uses this as its coverage
    universe: a new point shipping without a chaos leg fails CI there."""
    return [
        CHECKPOINT_SAVE,
        CHECKPOINT_LOAD,
        READER_NEXT,
        TRAINER_STEP,
        SERVING_DISPATCH,
        DECODE_STEP,
        DECODE_RECOVER,
        DISAGG_HANDOFF,
        HOST_TIER,
        GROUP_MEMBER,
        DEVICE_LOST,
        PREEMPT_NOTICE,
    ]


class DeviceLostError(RuntimeError):
    """A device (or its host process) stopped responding mid-training.

    Raised by ``inject(DEVICE_LOST)`` under an ``"error"`` spec with no
    explicit ``exc``, and by the elastic supervisor's probe escalation.
    Carries the indices of the lost devices (into the supervisor's initial
    device list) when known, so the mesh can shrink past exactly them.
    Defined here (not in ``elastic.py``) so ``inject`` can default to it
    without a circular import."""

    def __init__(self, message: str = "device lost", device_indices=()):
        super().__init__(message)
        self.device_indices = tuple(device_indices)


class FaultSpec:
    """One scheduled fault at one injection point."""

    def __init__(
        self,
        point: str,
        kind: str = "error",
        *,
        after: int = 0,
        times: int = 1,
        p: Optional[float] = None,
        exc: Optional[BaseException] = None,
        stall_s: float = 0.0,
        match: Optional[Dict[str, Any]] = None,
    ):
        enforce_in(kind, _KINDS, "fault kind")
        enforce(times >= 1, f"times must be >= 1, got {times}")
        enforce(after >= 0, f"after must be >= 0, got {after}")
        enforce(p is None or 0.0 < p <= 1.0, f"p must be in (0, 1], got {p}")
        self.point = point
        self.kind = kind
        self.after = after
        self.times = times
        self.p = p
        self.exc = exc
        self.stall_s = float(stall_s)
        # only hits whose context contains these key/value pairs count
        # (e.g. match={"replica": 0} pins a serving fault to one replica)
        self.match = dict(match or {})
        self.hits = 0   # matching calls observed
        self.fired = 0  # faults actually triggered

    def __repr__(self):
        return (
            f"FaultSpec({self.point!r}, {self.kind!r}, after={self.after}, "
            f"times={self.times}, p={self.p}, fired={self.fired})"
        )

    def _matches(self, ctx: Dict[str, Any]) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())

    def _due(self, rng: random.Random) -> bool:
        """Called with the plan lock held, after ``hits`` was bumped."""
        if self.p is not None:
            return self.fired < self.times and rng.random() < self.p
        hit = self.hits - 1  # 0-based index of this hit
        return self.after <= hit < self.after + self.times


class FaultPlan:
    """An installed set of specs sharing one seeded rng."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.rng = random.Random(seed)
        self._lock = locks.Lock("resilience.fault_plan")

    def stats(self) -> Dict[str, int]:
        """point -> total faults fired (summed over specs)."""
        with self._lock:
            out: Dict[str, int] = {}
            for s in self.specs:
                out[s.point] = out.get(s.point, 0) + s.fired
            return out

    def all_fired(self) -> bool:
        """True when every spec triggered at least once — chaos_smoke's
        "the schedule actually ran" assertion."""
        with self._lock:
            return all(s.fired > 0 for s in self.specs)


_plan: Optional[FaultPlan] = None


def install(*specs: FaultSpec, seed: int = 0) -> FaultPlan:
    """Install a fault plan (replacing any active one). Returns the plan so
    callers can read per-spec ``fired`` counters afterwards."""
    global _plan
    _plan = FaultPlan(list(specs), seed=seed)
    return _plan


def clear() -> None:
    global _plan
    _plan = None


def active_plan() -> Optional[FaultPlan]:
    return _plan


def stats() -> Dict[str, int]:
    """Fired-fault counts of the active plan ({} when none installed)."""
    return _plan.stats() if _plan is not None else {}


class injected:
    """Context manager: install specs on enter, restore the previous plan on
    exit (tests)."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self._specs = specs
        self._seed = seed
        self._prev: Optional[FaultPlan] = None
        self.plan: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _plan
        self._prev = _plan
        self.plan = install(*self._specs, seed=self._seed)
        return self.plan

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        global _plan
        _plan = self._prev
        return False


def inject(point: str, **ctx: Any) -> Optional[FaultSpec]:
    """Fault injection point. No-op (returns None) unless an installed spec
    matches ``point`` (+ ``ctx``) and its schedule says this hit fires.

    ``"error"``/``"preempt"`` act here (raise / SIGTERM); ``"nan"`` and
    ``"stall"`` return the fired spec so the call site applies the fault to
    its own state. At most one spec fires per call (first match wins)."""
    plan = _plan
    if plan is None:
        return None
    fired: Optional[FaultSpec] = None
    with plan._lock:
        for spec in plan.specs:
            if spec.point != point or not spec._matches(ctx):
                continue
            spec.hits += 1
            if spec._due(plan.rng):
                spec.fired += 1
                fired = spec
                break
    if fired is None:
        return None
    prof.inc_counter("resilience.faults_fired", labels={"point": point})
    runlog.emit("fault_injected", point=point, fault_kind=fired.kind)
    ptlog.warning(
        "fault injected at %s (%s, fired %d): ctx=%r",
        point, fired.kind, fired.fired, ctx,
    )
    if fired.kind == "error":
        if fired.exc is not None:
            raise fired.exc
        if point == DEVICE_LOST:  # the classified hardware-loss error
            raise DeviceLostError(f"injected fault at {point}")
        raise OSError(f"injected fault at {point}")
    if fired.kind == "stall":
        time.sleep(fired.stall_s)
        return fired
    if fired.kind == "preempt":
        # the real thing: the cluster-preemption signal, delivered to this
        # process; the Trainer's handler checkpoints at the step boundary
        os.kill(os.getpid(), signal.SIGTERM)
        return fired
    return fired  # "nan": the caller poisons its own numerics
