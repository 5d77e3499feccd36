"""The host-side pieces of ``paddle_tpu.serving.recovery`` that the decode
engine's recovery ladder uses: the typed :class:`RetriesExhausted` and
:class:`EngineUnhealthy` errors, and the :class:`RescuePacket` from which a
generation continues token-exactly (``DecodeEngine.adopt_rescue``).

Step-fault recovery itself lives in ``serving.decode``: a failed decode
iteration quarantines the batch and re-admits every live request through
the preempt/resume path, under a per-request retry budget. The durable
request journal (``RequestJournal``, ``replay_journal``,
``resume_incomplete``) and cross-engine migration (``DecodeFleet``) are
not ported yet (``ROADMAP.md`` §A item 6, after the static engine).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np

__all__ = ["EngineUnhealthy", "RescuePacket", "RetriesExhausted"]


class RetriesExhausted(RuntimeError):
    """A request burned through its recovery budget — the fault follows
    it across quarantine cycles, so it is the poison. Carries the request
    id so clients can correlate with runlog records."""

    def __init__(self, message: str, request_id: Optional[str] = None):
        super().__init__(message)
        self.request_id = request_id


class EngineUnhealthy(RuntimeError):
    """No healthy engine could take the work (the engine was killed)."""


@dataclasses.dataclass
class RescuePacket:
    """Everything needed to continue one generation on another engine:
    pure host-side state (the KV cache is rebuilt by re-prefill, which
    the preempt/resume path proves token-exact). ``handle`` is the
    client's original future — adoption repoints it at the adopting
    engine's request so ``result()``/``cancel()`` keep working; None
    makes the adopter mint a fresh handle."""

    rid: str
    prompt: np.ndarray
    mnt: int
    generated: List[int]
    tenant: str = "default"
    cls: str = "interactive"
    deadline: Optional[float] = None
    t_submit: float = 0.0
    n_preemptions: int = 0
    handle: Optional[Any] = None
    # the request's root span context (tracing.SpanContext): the adopting
    # engine continues the same trace
    trace: Optional[Any] = None
    cancelled: bool = False
