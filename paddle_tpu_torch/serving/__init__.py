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

Several engines make a fleet: :class:`DecodeFleet` routes to the
least-loaded healthy engine (by cached-prefix depth first, with
``DecodeConfig(prefix_digest=True)``) and migrates a tripped engine's
requests; :class:`RequestJournal` (``DecodeConfig(journal_path=...)``)
makes requests survive the process (:func:`replay_journal`,
:func:`resume_incomplete`); a shared :class:`HostPagePool`
(``DecodeEngine(host_tier=...)``) keeps demoted prefix pages in host RAM
across engines; :class:`DisaggRouter` splits prefill and decode onto
separate workers with a KV-page handoff (:class:`HandoffPayload`) and an
:class:`Autoscaler` to rebalance them::

    from paddle_tpu_torch.serving import DisaggRouter
    from paddle_tpu_torch.serving.disagg import DECODE, PREFILL

    router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport="device")
    out = router.submit(prompt_ids, 64).result()
    router.close()

Not ported yet: replica groups (``serving.shardgroup``, ``ROADMAP.md`` §A
item 4c).
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
from paddle_tpu_torch.serving.disagg import (
    Autoscaler,
    AutoscalerConfig,
    DisaggRouter,
    HandoffCorrupt,
    HandoffPayload,
)
from paddle_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineClosedError,
    PendingResult,
    ReplicaDied,
    ServingConfig,
    ServingEngine,
)
from paddle_tpu_torch.serving.host_tier import (
    HostPageCorrupt,
    HostPagePool,
    prefix_digests,
)
from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE, PageAllocator, PagedKVCache
from paddle_tpu_torch.serving.metrics import DecodeMetrics, ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.serving.recovery import (
    DecodeFleet,
    EngineUnhealthy,
    RequestJournal,
    RescuePacket,
    RetriesExhausted,
    replay_journal,
    resume_incomplete,
)
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
    "RequestJournal", "replay_journal", "resume_incomplete", "DecodeFleet",
    "HostPagePool", "HostPageCorrupt", "prefix_digests",
    "HandoffPayload", "HandoffCorrupt", "DisaggRouter", "Autoscaler", "AutoscalerConfig",
]
