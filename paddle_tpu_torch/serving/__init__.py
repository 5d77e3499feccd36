"""paddle_tpu_torch.serving — continuous-batching decode serving of the
transformer LM, port of ``paddle_tpu.serving``'s decode path.

Requests pass multi-tenant admission control (``serving.admission``:
quotas, per-token deadline feasibility, brownout shedding), queue per
tenant under a weighted-fair scheduler (``serving.scheduler``), and are
admitted into and evicted from the running decode batch between
iterations (``serving.decode``) over a paged KV cache
(``serving.kv_cache``), with chunked prefill, LIFO preemption, a radix
prefix cache (``serving.prefix_cache``), draft-and-verify speculative
decoding and in-engine step-fault recovery (``serving.recovery``)::

    from paddle_tpu_torch.serving import DecodeEngine, DecodeConfig

    eng = DecodeEngine(variables, cfg, decode=DecodeConfig(max_slots=8))
    out = eng.infer(prompt_ids, max_new_tokens=64)   # DecodeOutput
    eng.close()

Not ported yet (``ROADMAP.md`` §A item 8): the static-batch
``ServingEngine`` and its micro-batcher, the request journal,
``DecodeFleet``, disaggregated prefill/decode, the host KV tier and
replica groups.
"""

from paddle_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionRejected,
    TenantConfig,
)
from paddle_tpu_torch.serving.decode import (
    DecodeConfig,
    DecodeCostModel,
    DecodeEngine,
    DecodeHandle,
    DecodeOutput,
)
from paddle_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineClosedError,
    PendingResult,
    ServingConfig,
)
from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE, PageAllocator, PagedKVCache
from paddle_tpu_torch.serving.metrics import DecodeMetrics
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.serving.recovery import EngineUnhealthy, RescuePacket, RetriesExhausted
from paddle_tpu_torch.serving.scheduler import CLASSES, WeightedFairScheduler

__all__ = [
    "AdmissionController", "AdmissionRejected", "TenantConfig",
    "DecodeConfig", "DecodeCostModel", "DecodeEngine", "DecodeHandle", "DecodeOutput",
    "DeadlineExceeded", "EngineClosedError", "PendingResult", "ServingConfig",
    "SCRATCH_PAGE", "PageAllocator", "PagedKVCache", "DecodeMetrics", "RadixPrefixCache",
    "EngineUnhealthy", "RescuePacket", "RetriesExhausted", "CLASSES", "WeightedFairScheduler",
]
