"""paddle_tpu_torch.serving — inference serving, port of
``paddle_tpu.serving``: the static micro-batching engine and the
continuous-batching decode engine of the transformer LM.

Static-shape models (classifiers, encoders, a forward that returns
logits) go through :class:`ServingEngine`: requests pass multi-tenant
admission control (``serving.admission``), queue per tenant under a
weighted-fair scheduler (``serving.scheduler``), are grouped by the
micro-batcher (``serving.batcher``) and padded to shape buckets
(``serving.buckets``), and run on round-robin replicas behind circuit
breakers::

    from paddle_tpu_torch.serving import ServingEngine, ServingConfig
    from paddle_tpu_torch.reader.feeder import FeedSpec

    engine = ServingEngine(infer_net, variables, [FeedSpec("x", (784,))],
                           config=ServingConfig(max_batch_size=16))
    out = engine.infer({"x": batch})
    engine.close()

Autoregressive decode goes through :class:`DecodeEngine`: requests are
admitted into and evicted from the running decode batch between
iterations (``serving.decode``) over a paged KV cache
(``serving.kv_cache``), with chunked prefill, LIFO preemption, a radix
prefix cache (``serving.prefix_cache``), draft-and-verify speculative
decoding and in-engine step-fault recovery (``serving.recovery``)::

    from paddle_tpu_torch.serving import DecodeEngine, DecodeConfig

    eng = DecodeEngine(variables, cfg, decode=DecodeConfig(max_slots=8))
    out = eng.infer(prompt_ids, max_new_tokens=64)   # DecodeOutput
    eng.close()

Not ported yet (``ROADMAP.md`` §A item 6): the request journal,
``DecodeFleet``, disaggregated prefill/decode, the host KV tier and
replica groups.
"""

from paddle_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionRejected,
    TenantConfig,
    TokenBucket,
)
from paddle_tpu_torch.serving.batcher import Group, MicroBatcher
from paddle_tpu_torch.serving.buckets import ShapeBuckets
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
    ReplicaDied,
    ServingConfig,
    ServingEngine,
)
from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE, PageAllocator, PagedKVCache
from paddle_tpu_torch.serving.metrics import DecodeMetrics, ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.serving.recovery import EngineUnhealthy, RescuePacket, RetriesExhausted
from paddle_tpu_torch.serving.scheduler import (
    BATCH,
    CLASSES,
    INTERACTIVE,
    WeightedFairScheduler,
)

__all__ = [
    "ServingEngine", "ServingConfig", "PendingResult", "DeadlineExceeded",
    "EngineClosedError", "ReplicaDied", "MicroBatcher", "Group", "ShapeBuckets",
    "ServingMetrics", "AdmissionController", "AdmissionRejected", "TenantConfig",
    "TokenBucket", "WeightedFairScheduler", "INTERACTIVE", "BATCH", "CLASSES",
    "DecodeConfig", "DecodeCostModel", "DecodeEngine", "DecodeHandle", "DecodeOutput",
    "SCRATCH_PAGE", "PageAllocator", "PagedKVCache", "DecodeMetrics", "RadixPrefixCache",
    "EngineUnhealthy", "RescuePacket", "RetriesExhausted",
]
