"""What the decode engine shares with the static-batch engine of
``paddle_tpu.serving.engine``: :class:`ServingConfig` (the tenant,
admission and cache-dtype knobs a :class:`~paddle_tpu_torch.serving.decode.
DecodeEngine` reads), the :class:`PendingResult` future, and the
:class:`DeadlineExceeded` / :class:`EngineClosedError` errors.

``ServingEngine`` itself — the static micro-batcher over shape buckets, its
replicas and their breakers — is not ported yet (``ROADMAP.md`` §A item 8),
and neither are the config fields only it reads (batch buckets, replicas,
warmup, the watch layer, retry budgets).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Sequence

from paddle_tpu_torch.serving.admission import TenantConfig

__all__ = ["ServingConfig", "PendingResult", "DeadlineExceeded", "EngineClosedError"]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it was served."""


class EngineClosedError(RuntimeError):
    """submit() after close() — the engine no longer accepts requests."""


@dataclasses.dataclass
class ServingConfig:
    """Request-intake policy knobs shared by the serving engines."""

    # bounded request queue when admission control is off: submit blocks
    # past this depth (backpressure)
    queue_capacity: int = 64
    # metric label distinguishing this engine's families in the registry;
    # None = auto ("decode0", "decode1", ... per process)
    engine_label: Optional[str] = None
    # default per-request deadline; None = no deadline
    default_deadline_s: Optional[float] = None
    # -- multi-tenant admission (serving.admission / serving.scheduler) ----
    # tenant set (admission.TenantConfig) for weighted-fair scheduling;
    # None = one implicit "default" tenant with legacy FIFO backpressure
    tenants: Optional[Sequence[TenantConfig]] = None
    # early typed shedding at submit() (AdmissionRejected); None = enabled
    # exactly when tenants are configured
    admission: Optional[bool] = None
    # guaranteed batch-class drain share under interactive pressure; None =
    # the tenant_batch_min_share flag
    batch_min_share: Optional[float] = None
    # minimum dwell in brownout before the SLO probe may exit it
    brownout_min_s: float = 1.0
    # KV-cache dtype for decode engines built over this config (e.g.
    # torch.bfloat16 halves the cache's memory traffic); None = f32
    cache_dtype: Optional[Any] = None


class PendingResult:
    """Future-like handle for one submitted request."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()
