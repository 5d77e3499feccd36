"""Continuous (iteration-level) batching for autoregressive decode — port of
``paddle_tpu.serving.decode``.

A static batch keeps every slot idle until its slowest request drains.
:class:`DecodeEngine` admits requests into, and evicts them from, the
running batch *between decode iterations*, so a slot freed by a short
generation is refilled on the very next step while long generations keep
streaming.

Execution model (single decode-loop thread)::

    submit(prompt, max_new_tokens) ──▶ admission control (per-token cost)
        ──▶ weighted-fair scheduler (DRR by predicted token cost)
        ──▶ slot + page assignment (serving.kv_cache)
        ──▶ chunked prefill, bounded per iteration (never stalls decode)
        ──▶ ONE decode step per iteration over all active slots
        ──▶ host-side finish checks (eos / budget / cancel / deadline)
        ──▶ freed slots refill from the queue before the next step

The KV cache is paged (:mod:`serving.kv_cache`): fixed-size pages plus
per-slot page tables, so the step's tensor shapes depend only on static
config ``(max_slots, table_width, page_size)``. Where the JAX package
compiles the step once, here the step has one shape:
:meth:`DecodeEngine.decode_step_cache_size` counts the distinct argument
signatures the step was called with, and stays 1 under admission, eviction
and preemption. Prefill runs as fixed-size chunks through the same pages,
at most ``prefill_chunks_per_iter`` per iteration.

The pages live on the engine's device and are written in place (the JAX
package threads them through each jitted call). A step that fails midway
may therefore leave partial writes; the recovery ladder never relies on
the pages: it releases every slot and re-prefills ``prompt + generated``.

When the page pool is exhausted mid-growth the engine preempts the most
recently admitted other request (LIFO): its pages are freed, its
generated prefix is kept, and it re-enters at the front of the line to
re-prefill ``prompt + generated`` and continue. Greedy decode therefore
produces identical tokens with or without preemption. ``num_pages`` must
exceed one slot's worth of pages (enforced), so a lone request can always
run to completion.

Deadline admission uses a per-token cost model (:class:`DecodeCostModel`):
predicted latency = chunks x chunk-EMA + max_new_tokens x step-EMA.

Sampling (``temperature > 0``) draws from one ``torch.Generator`` on the
engine's device, seeded from ``DecodeConfig.rng_seed``, so sampled tokens
differ from the JAX package's (``jax.random``); greedy decode is
token-exact against it.

The fleet hooks are the JAX package's: the durable request journal
(``DecodeConfig.journal_path``, ``serving.recovery.RequestJournal``:
admission journaled before enqueue, every token, every finish), migration
on a tripped breaker (``_rescue_sink``, set by a ``DecodeFleet``), the
host KV tier behind the radix tree (``host_tier=``/``host_tier_bytes``,
``serving.host_tier``: write-through demote on a finished prefill,
budgeted promotes on the loop thread), prefix-digest publication
(``prefix_digest``) and disaggregated prefill/decode (``_handoff_sink``
on a prefill worker, :meth:`DecodeEngine.adopt_handoff` on a decode
worker, ``serving.disagg``). A handed-off request's pages move card to
card without a host hop: one ``index_select`` from the prefill worker's
page arrays, one ``index_copy_`` into the decode worker's.

**Replica groups** (``group=``, ``serving.shardgroup``): the engine's
steps span a tensor-parallel group's member devices, all driven by this
process. The layout lint (``analysis.shard_analysis``) runs before
anything is placed; then every member holds its block of the parameters
(``GroupLayout.shard_params``) and of the KV pages (the head dim), the
draft's too, and the step is ``GroupPagedDecoder``'s, whose row-parallel
sums are the group's collective. The scheduler, page allocator, prefix
cache, journal and breaker stay single: page ids are global across the
members. A per-member canary (``probe_members``, every
``group_probe_every_s``) feeds the shard-skew straggler watch; a member
fault ejects the whole group (breaker trip, then migration through the
fleet, else quarantine). Handoff and host-tier pages are always whole
logical pages: gathered from the members' head shards, split back on
implant.

Not ported yet, and refused with ``NotImplementedError``: manifest
prewarm (``prewarm=True``, the ``tune/`` warm-up manifest, ``ROADMAP.md``
§A item 7).

Telemetry as in the JAX package: with tracing on
(``tracing.tracing_enabled()``, the default) every request is a trace
(``serving.decode.request`` with ``serving.decode.queue_wait`` and
``serving.decode.prefill`` children) and the loop a trace of its own
(``serving.decode.step`` and ``serving.decode.verify`` spans). The step,
prefill, draft and verify calls go through the roofline ledger
(``observability/roofline.py``: each call's FLOPs and bytes counted on its
first call, its device time from CUDA events after that, with no wait on
the card). A breaker trip and :meth:`DecodeEngine.kill` dump a flight
recorder bundle when one is installed
(``observability/flight_recorder.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import zlib
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import tracing
from paddle_tpu_torch.concurrency import ChannelClosedError, go
from paddle_tpu_torch.core import config as cfg_mod
from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import retry as retry_mod
from paddle_tpu_torch.core.dtypes import ieee_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.models.transformer_lm import (
    GroupPagedDecoder,
    PagedDecoder,
    _params_on,
    _sample,
    paged_cache_shape,
)
from paddle_tpu_torch.observability import roofline, runlog
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.circuit import CircuitBreaker
from paddle_tpu_torch.serving import admission as admission_mod
from paddle_tpu_torch.serving import scheduler as sched_mod
from paddle_tpu_torch.serving.admission import AdmissionRejected, TenantConfig
from paddle_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineClosedError,
    PendingResult,
    ServingConfig,
)
from paddle_tpu_torch.serving.host_tier import HostPageCorrupt, HostPagePool
from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE, PagedKVCache
from paddle_tpu_torch.serving.metrics import DecodeMetrics
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.serving.recovery import (
    EngineUnhealthy,
    RequestJournal,
    RescuePacket,
    RetriesExhausted,
)
from paddle_tpu_torch.serving.shardgroup import (
    KV_HEAD_DIM,
    GroupLayout,
    GroupStragglerWatch,
    ReplicaGroup,
    default_layout,
    probe_members,
)
from paddle_tpu_torch.tracing import waterfall

__all__ = [
    "DecodeConfig",
    "DecodeCostModel",
    "DecodeEngine",
    "DecodeHandle",
    "DecodeOutput",
]

# request-id salt: keeps rids unique across processes
_RID_SALT = os.urandom(3).hex()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"DecodeEngine: {what} is not ported to paddle_tpu_torch yet "
        f"(ROADMAP.md §A item {item})")


def _page_stack(pages) -> torch.Tensor:
    """A handoff's pages as one ``[n, ...]`` tensor (the device transport's
    gather is one already)."""
    return pages if isinstance(pages, torch.Tensor) else torch.stack(list(pages))


@dataclasses.dataclass
class DecodeConfig:
    """Continuous-batching policy knobs (the model/tenant/admission side
    rides on :class:`~paddle_tpu_torch.serving.engine.ServingConfig`)."""

    # concurrent sequences per decode step (the step's static batch dim)
    max_slots: int = 4
    # tokens per KV page; pages are the device-memory allocation granularity
    page_size: int = 16
    # per-sequence position capacity (prompt + generation); must be a
    # multiple of both page_size and prefill_chunk
    max_context: int = 256
    # physical page pool; None = every slot fully grown + scratch
    num_pages: Optional[int] = None
    # prompt tokens absorbed per prefill call (fixed-shape chunks)
    prefill_chunk: int = 32
    # prefill chunks run per decode iteration (prefill never monopolizes
    # the loop; decode steps keep landing between chunks)
    prefill_chunks_per_iter: int = 1
    # sampling policy (engine-wide; greedy by default)
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    rng_seed: int = 0
    # stop token; None = run every request to its max_new_tokens budget
    eos_id: Optional[int] = None
    # KV page dtype; overrides ServingConfig.cache_dtype when set
    cache_dtype: Optional[Any] = None
    # run the prefill + step (+ verify) once at init on the scratch page
    warmup: bool = True
    # replay a persisted warmup manifest (tune/): not ported, True raises
    prewarm: Optional[bool] = None
    # idle poll interval on the scheduler when no slot is active
    idle_poll_s: float = 0.02
    # -- speculative decoding (draft-and-verify) --------------------------
    # draft tokens proposed per verify iteration; takes effect when the
    # engine is built with draft model params (greedy only — acceptance
    # compares argmaxes, so temperature must stay 0.0)
    spec_tokens: int = 4
    # -- radix prefix cache (serving.prefix_cache) ------------------------
    # share prompt-prefix KV pages across requests: a hit skips whole
    # prefill chunks; pages are refcounted with copy-on-write
    prefix_cache: bool = False
    # page budget for the tree (LRU-evicted past it); None = unbounded,
    # evicted only under allocator pressure
    prefix_cache_pages: Optional[int] = None
    # -- zero-loss recovery (serving.recovery) ----------------------------
    # survive decode-step faults by quarantining the poisoned iteration
    # and re-admitting live requests through the resume path (False = one
    # step fault fails every in-flight request)
    recovery: bool = True
    # per-request quarantine budget over its LIFETIME (not reset on
    # progress — re-prefill samples one token per cycle, so a progress
    # reset would let a deterministic poison loop forever): past this
    # many re-admissions the request fails with RetriesExhausted
    recovery_retries: int = 8
    # decorrelated-jitter backoff between faulted iterations (core.retry)
    recovery_base_delay_s: float = 0.002
    recovery_max_delay_s: float = 0.1
    # consecutive faulted decode iterations before this engine's
    # CircuitBreaker trips (the engine reports itself unhealthy)
    unhealthy_after: int = 3
    breaker_cooldown_s: float = 0.25
    breaker_max_cooldown_s: float = 5.0
    # durable request journal (WAL): records admissions + every
    # generated token; recovery.replay_journal()/resume_incomplete()
    # rebuild in-flight work after a process restart. None = off.
    journal_path: Optional[str] = None
    journal_fsync_every: int = 16
    # WAL size (bytes) that triggers an in-place compaction: finished
    # requests drop, incomplete ones are rewritten as snapshots into a
    # fresh segment (atomic publish). None = unbounded growth.
    journal_compact_bytes: Optional[int] = None
    # -- replica groups (serving.shardgroup) ------------------------------
    # per-member canary cadence when the engine is group-backed: each
    # member device is timed individually so a fault or stall is
    # attributable to ONE member of the group
    group_probe_every_s: float = 0.05
    # per-shard probe-time skew (vs the median shard) that flags a
    # straggler member inside the group
    group_skew_ratio: float = 4.0
    # statically lint the GroupLayout against the actual param tree + KV
    # geometry BEFORE placing anything on devices (analysis.shard_analysis):
    # layout errors (dead rules, rank mismatches, kv-geometry violations)
    # raise here instead of surfacing as a wrong placement
    lint_layout: bool = True
    # -- hierarchical KV host tier (serving.host_tier) --------------------
    # byte budget for a PRIVATE host-RAM page pool behind the radix tree
    # (requires prefix_cache): radix inserts write through to host RAM,
    # radix misses whose continuation the pool holds promote back
    # asynchronously. None = no private pool; pass a shared HostPagePool
    # to DecodeEngine(host_tier=...) for fleet-wide sharing + crash
    # recovery (the pool survives any one engine's kill()).
    host_tier_bytes: Optional[int] = None
    # publish a compact per-prefix digest set for prefix-aware fleet
    # routing: DecodeFleet/DisaggRouter route each prompt to the engine
    # with the longest cached prefix (least-loaded tiebreak)
    prefix_digest: bool = False
    # promote-apply budget: pages implanted from the host tier per loop
    # iteration — bounds the latency promotion adds to one iteration
    host_promote_pages_per_iter: int = 4


@dataclasses.dataclass
class DecodeOutput:
    """One finished generation. ``tokens`` holds the generated ids
    (including ``eos_id`` when that ended it); ``finish_reason`` is
    ``"eos"`` | ``"length"`` | ``"cancelled"`` | ``"drain_timeout"``
    (close() deadline enforced: partial tokens returned)."""

    tokens: np.ndarray
    finish_reason: str
    prompt_len: int
    n_preemptions: int = 0


class DecodeHandle(PendingResult):
    """Future for one decode request, plus mid-generation cancellation:
    :meth:`cancel` marks the request; the loop completes it with the
    tokens generated so far (``finish_reason="cancelled"``) at the next
    iteration boundary."""

    def __init__(self, req: "_DecodeRequest"):
        super().__init__()
        self._req = req

    def cancel(self) -> None:
        self._req.cancelled = True


class _DecodeRequest:
    __slots__ = ("prompt", "mnt", "n", "bytes", "tenant", "cls", "deadline",
                 "t_submit", "handle", "generated", "slot", "phase", "seq",
                 "chunks_done", "cur_len", "last_tok", "cancelled",
                 "n_preemptions", "rid", "recoveries", "trace",
                 "t_enqueue_pc", "t_admit_pc")

    def __init__(self, prompt: np.ndarray, mnt: int, n_chunks: int,
                 deadline: Optional[float], t_submit: float,
                 tenant: str = "default", cls: str = "interactive"):
        self.prompt = prompt
        self.mnt = mnt
        # DRR weight: predicted device iterations (decode steps + prefill
        # chunks), so fairness is by token cost, not request count
        self.n = mnt + n_chunks
        self.bytes = int(prompt.nbytes)
        self.tenant = tenant
        self.cls = cls
        self.deadline = deadline
        self.t_submit = t_submit
        self.handle = DecodeHandle(self)
        self.generated: List[int] = []
        self.slot: Optional[int] = None
        self.phase = "queued"          # queued | prefill | decode
        self.seq: Optional[np.ndarray] = None  # tokens being prefilled
        self.chunks_done = 0
        self.cur_len = 0               # K/V positions written so far
        self.last_tok = 0              # next token to feed the step
        self.cancelled = False
        self.n_preemptions = 0
        self.rid: Optional[str] = None
        self.recoveries = 0              # quarantine cycles survived
        # tracing: the request's root span context and its queue timeline
        self.trace: Optional[tracing.SpanContext] = None
        self.t_enqueue_pc: Optional[float] = None
        self.t_admit_pc: Optional[float] = None


class DecodeCostModel:
    """EMA cost model for decode admission: per-iteration step cost and
    per-chunk prefill cost, observed by the loop. ``step_s``/``chunk_s``
    preset the EMAs (deterministic tests / warm handoff); cold (no step
    observations and no preset) estimates are None so admission falls
    back to admitting everything — shedding on zero data would reject
    the traffic that builds the model."""

    def __init__(self, alpha: float = 0.2, step_s: Optional[float] = None,
                 chunk_s: Optional[float] = None,
                 verify_s: Optional[float] = None,
                 accepted_per_step: Optional[float] = None):
        enforce(0.0 < alpha <= 1.0, f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._step_s = step_s
        self._chunk_s = chunk_s
        # speculative decoding: per-verify-iteration cost and how many
        # tokens one iteration lands on average (1 + accepted drafts)
        self._verify_s = verify_s
        self._accepted = accepted_per_step
        self._lock = locks.Lock("serving.decode_cost_model")

    def _ema(self, old: Optional[float], new: float) -> float:
        return new if old is None else self.alpha * new + (1 - self.alpha) * old

    def observe_step(self, seconds: float) -> None:
        with self._lock:
            self._step_s = self._ema(self._step_s, seconds)

    def observe_chunk(self, seconds: float) -> None:
        with self._lock:
            self._chunk_s = self._ema(self._chunk_s, seconds)

    def observe_verify(self, seconds: float, accepted_tokens: float) -> None:
        """One draft-and-verify iteration: its wall cost (drafting
        included) and the tokens it landed per participating slot."""
        with self._lock:
            self._verify_s = self._ema(self._verify_s, seconds)
            self._accepted = self._ema(self._accepted, accepted_tokens)

    def estimate(self, n_chunks: int, max_new_tokens: int,
                 queue_cost: int = 0) -> Optional[float]:
        """Predicted service latency: prefill chunks + decode iterations,
        plus ``queue_cost`` iterations already queued ahead. Under
        speculation an iteration is one verify step landing
        ``accepted_per_step`` tokens; otherwise one step = one token.
        None while cold."""
        with self._lock:
            step_s, chunk_s = self._step_s, self._chunk_s
            verify_s, accepted = self._verify_s, self._accepted
        if verify_s is not None:
            tokens_per_iter = max(accepted if accepted else 1.0, 1.0)
            if chunk_s is None:
                chunk_s = verify_s
            return (n_chunks * chunk_s + max_new_tokens / tokens_per_iter * verify_s
                    + queue_cost * verify_s)
        if step_s is None:
            return None
        if chunk_s is None:
            chunk_s = step_s
        return n_chunks * chunk_s + max_new_tokens * step_s + queue_cost * step_s

    def snapshot(self):
        with self._lock:
            return {"step_s": self._step_s, "chunk_s": self._chunk_s,
                    "verify_s": self._verify_s,
                    "accepted_per_step": self._accepted}


class DecodeEngine:
    """Iteration-level batched autoregressive serving over a trained
    transformer LM (parameters as created by
    :func:`~paddle_tpu_torch.models.transformer_lm.lm_forward`), on
    ``device`` (default CUDA; raises if CUDA is absent unless
    ``device="cpu"``), which must hold the parameters.

    ::

        eng = DecodeEngine(variables, cfg, decode=DecodeConfig(max_slots=8))
        out = eng.infer(prompt_ids, max_new_tokens=32)   # DecodeOutput
        h = eng.submit(prompt_ids, 128)                  # async
        h.cancel()                                       # mid-generation
        eng.close()                                      # graceful drain

    Passing ``draft_variables`` (plus its ``draft_cfg`` when the draft is
    a different architecture) turns on draft-and-verify speculative
    decoding: each iteration the draft proposes ``DecodeConfig.spec_tokens``
    tokens sequentially, one ``paged_verify_step`` scores all of them (plus
    the bonus position) against the target's paged cache, and the longest
    draft prefix matching the target's own greedy choices is accepted —
    token-exact vs ``generate()`` by construction. The draft shares the
    slot page tables and allocator geometry with its own page tensors.
    ``DecodeConfig.prefix_cache=True`` adds the radix prefix cache: hot
    prompt prefixes prefill once and later requests adopt the shared
    pages (refcounted, copy-on-write).

    ``group=`` (a :class:`~paddle_tpu_torch.serving.shardgroup.ReplicaGroup`)
    serves on a tensor-parallel replica group under ``layout`` (default
    :func:`~paddle_tpu_torch.serving.shardgroup.default_layout`): the
    engine's device is the group's member 0, and the parameters (on any
    device) are placed block by block on the members.
    """

    def __init__(
        self,
        variables,
        model_cfg: dict,
        *,
        config: Optional[ServingConfig] = None,
        decode: Optional[DecodeConfig] = None,
        draft_variables=None,
        draft_cfg: Optional[dict] = None,
        group: Optional[ReplicaGroup] = None,
        layout: Optional[GroupLayout] = None,
        host_tier=None,
        device=None,
    ):
        self.config = config or ServingConfig()
        self.decode_config = dconf = decode or DecodeConfig()
        self.model_cfg = dict(model_cfg)
        if dconf.prewarm:
            raise _not_ported("prewarm=True (the tune/ warmup manifest)", "7")
        enforce(dconf.max_slots >= 1,
                f"max_slots must be >= 1, got {dconf.max_slots}")
        enforce(dconf.prefill_chunk >= 1,
                f"prefill_chunk must be >= 1, got {dconf.prefill_chunk}")
        enforce(dconf.max_context % dconf.page_size == 0,
                f"max_context ({dconf.max_context}) must be a multiple of "
                f"page_size ({dconf.page_size})")
        # padded prompt chunks must stay inside the slot's table span
        enforce(dconf.max_context % dconf.prefill_chunk == 0,
                f"max_context ({dconf.max_context}) must be a multiple of "
                f"prefill_chunk ({dconf.prefill_chunk})")
        if group is not None:
            members = [cfg_mod.resolve_device(d) for d in group.devices]
            enforce(device is None or cfg_mod.resolve_device(device) == members[0],
                    f"DecodeEngine: device={device!r} is not the group's member 0 "
                    f"({members[0]}); a group engine runs on its members")
            device = members[0]
        self._device = cfg_mod.resolve_device("cuda" if device is None else device)
        pages_per_slot = dconf.max_context // dconf.page_size
        num_pages = (dconf.num_pages if dconf.num_pages is not None
                     else 1 + dconf.max_slots * pages_per_slot)
        self._kv = PagedKVCache(
            max_slots=dconf.max_slots, page_size=dconf.page_size,
            num_pages=num_pages, pages_per_slot=pages_per_slot)
        self.metrics = DecodeMetrics(engine_label=self.config.engine_label)
        self.cost = DecodeCostModel()

        # replica-group mode (serving.shardgroup): every member holds its
        # block of the parameters and of the pages, and the step functions
        # are GroupPagedDecoder's over the members' tensors
        self._group = group
        self._layout = (layout or default_layout()) if group is not None else None
        self._straggler = (GroupStragglerWatch(group, ratio=dconf.group_skew_ratio)
                           if group is not None else None)
        self._last_probe = 0.0
        cdt = (dconf.cache_dtype if dconf.cache_dtype is not None
               else self.config.cache_dtype)
        self._cache_dtype = cdt or torch.float32
        pshape = paged_cache_shape(self.model_cfg, num_pages, dconf.page_size)
        # one logical page [L, H_kv, page_size, dh]: a handoff's and the
        # host tier's unit, whole whatever the group splits
        self._page_shape = (pshape[0],) + tuple(pshape[2:])
        if group is None:
            params = _params_on(variables, self._device, "DecodeEngine")
            self._model = PagedDecoder(params, self.model_cfg, dconf.page_size, pages_per_slot)
            self._k_pages = torch.zeros(pshape, dtype=self._cache_dtype, device=self._device)
            self._v_pages = torch.zeros(pshape, dtype=self._cache_dtype, device=self._device)
        else:
            params = variables.params if hasattr(variables, "params") else variables
            if dconf.lint_layout:
                # fail on a bad layout BEFORE any placement: errors raise
                # with every finding listed, warnings warn_once
                from paddle_tpu_torch.analysis.shard_analysis import (
                    lint_group_layout_or_raise,
                )

                lint_group_layout_or_raise(
                    params, self._layout, group.mesh,
                    kv_page_shape=pshape, kv_geometry=self._kv.geometry(),
                    where=f"DecodeEngine[{group.name}]")
            self._model, self._k_pages, self._v_pages = self._place_group(
                params, self.model_cfg, pshape, pages_per_slot)
        # roofline-instrumented model calls: each call's counted costs on
        # its first call, its device time after that
        self._prefill = roofline.instrument("serving.decode.prefill", self._model.prefill_chunk)
        self._step = roofline.instrument("serving.decode.step", self._decode_and_sample)
        self._verify = roofline.instrument("serving.decode.verify", self._model.verify_step)
        self._gen = (torch.Generator(device=self._device).manual_seed(dconf.rng_seed)
                     if dconf.temperature > 0.0 else None)
        # distinct argument signatures each step function was called with
        # (the "compiles once" contract of the JAX package as "one shape")
        self._signatures = {"prefill": set(), "step": set(), "verify": set()}

        # -- speculative decoding (draft-and-verify) ----------------------
        self._spec_k = 0
        if draft_variables is not None:
            enforce(dconf.spec_tokens >= 1,
                    f"spec_tokens must be >= 1 with a draft model, "
                    f"got {dconf.spec_tokens}")
            enforce(dconf.temperature == 0.0,
                    "speculative decoding is greedy-only: acceptance "
                    "compares argmaxes, so temperature must be 0.0")
            self.draft_cfg = dict(draft_cfg) if draft_cfg else self.model_cfg
            enforce(self.draft_cfg.get("vocab") == self.model_cfg.get("vocab"),
                    "draft and target models must share a vocabulary "
                    f"({self.draft_cfg.get('vocab')} vs "
                    f"{self.model_cfg.get('vocab')})")
            self._spec_k = int(dconf.spec_tokens)
            # the draft reads/writes THROUGH the same page tables: its own
            # page tensors, same (num_pages, page_size) geometry, so slot
            # bookkeeping (grow/preempt/trim) covers both caches at once
            dshape = paged_cache_shape(self.draft_cfg, num_pages, dconf.page_size)
            if group is None:
                dparams = _params_on(draft_variables, self._device, "DecodeEngine draft")
                self._draft = PagedDecoder(dparams, self.draft_cfg, dconf.page_size,
                                           pages_per_slot)
                self._dk_pages = torch.zeros(dshape, dtype=self._cache_dtype,
                                             device=self._device)
                self._dv_pages = torch.zeros(dshape, dtype=self._cache_dtype,
                                             device=self._device)
            else:
                dparams = (draft_variables.params if hasattr(draft_variables, "params")
                           else draft_variables)
                self._draft, self._dk_pages, self._dv_pages = self._place_group(
                    dparams, self.draft_cfg, dshape, pages_per_slot)
            self._draft_prefill = roofline.instrument("serving.decode.draft_prefill",
                                                      self._draft.prefill_chunk)
            self._draft_step = roofline.instrument("serving.decode.draft_step",
                                                   self._draft.decode_step)

        # -- radix prefix cache -------------------------------------------
        self._prefix: Optional[RadixPrefixCache] = None
        if dconf.prefix_cache:
            self._prefix = RadixPrefixCache(
                self._kv.allocator, dconf.page_size,
                max_pages=dconf.prefix_cache_pages)

        # -- hierarchical KV host tier (serving.host_tier) ----------------
        # a pool passed in is SHARED (fleet-wide prefix sharing + crash
        # recovery: it survives this engine's kill()); host_tier_bytes
        # builds a private one. Draft-model engines skip the tier — the
        # pool carries only target-cache pages, and adopting them without
        # the draft's would desynchronize speculation (same rationale as
        # handoff adoption degrading to re-prefill).
        self._host_tier: Optional[HostPagePool] = host_tier
        if self._host_tier is None and dconf.host_tier_bytes:
            self._host_tier = HostPagePool(dconf.host_tier_bytes, dconf.page_size)
        if self._host_tier is not None and self._spec_k:
            ptlog.warning(
                "host tier disabled for engine %s: the pool carries only "
                "target-cache pages, which a speculative engine cannot "
                "adopt", self.config.engine_label)
            self._host_tier = None
        if self._host_tier is not None:
            enforce(self._prefix is not None,
                    "host tier requires DecodeConfig(prefix_cache=True): "
                    "it extends the radix tree, not the raw page pool")
            enforce(self._host_tier.compatible(dconf.page_size),
                    f"host tier page_size {self._host_tier.page_size} != "
                    f"engine page_size {dconf.page_size}")
        # promote jobs applied on the loop thread, budgeted per iteration
        # (host_promote_pages_per_iter); keys dedup in-flight prefixes
        self._promote_jobs: Deque = deque()
        self._promote_keys: set = set()
        # prefix-aware routing digest: republished (lock-free swap of an
        # immutable frozenset) on the loop thread whenever the tree's
        # digest_version moved; fleets read it from any thread
        self._digest_pub: frozenset = frozenset()
        self._digest_seen = -1

        # tenants / scheduler / admission; deadline feasibility runs
        # through the per-token cost model
        tenant_cfgs = [t.resolved() for t in (self.config.tenants or ())]
        if not tenant_cfgs:
            tenant_cfgs = [TenantConfig(
                "default", queue_capacity=self.config.queue_capacity,
            ).resolved()]
        self._tenants = {t.name: t for t in tenant_cfgs}
        self._default_tenant = (
            "default" if "default" in self._tenants else tenant_cfgs[0].name)
        admission_on = (self.config.admission
                        if self.config.admission is not None
                        else self.config.tenants is not None)
        self._queue = sched_mod.WeightedFairScheduler(
            self._tenants,
            quantum_rows=max(8, dconf.max_slots * 8),
            batch_min_share=(self.config.batch_min_share
                             if self.config.batch_min_share is not None
                             else cfg_mod.flags().tenant_batch_min_share),
            legacy_capacity=(None if admission_on
                             else self.config.queue_capacity),
            on_expired=self._expire,
        )
        self._admission: Optional[admission_mod.AdmissionController] = None
        if admission_on:
            self._admission = admission_mod.AdmissionController(
                self._queue, self.metrics, self._tenants,
                request_cost=self._request_cost,
                brownout_min_s=self.config.brownout_min_s,
            )
            admission_mod.install(self._admission)

        self._active: List[_DecodeRequest] = []     # admission order
        self._resume: Deque[_DecodeRequest] = deque()
        self._pending_admit: Deque[_DecodeRequest] = deque()
        # disaggregated serving (serving.disagg): a prefill-role engine
        # publishes finished prefills through _handoff_sink instead of
        # decoding them; a decode-role engine admits adopted payloads
        # from _pending_handoff (implanted on the loop thread)
        self._handoff_sink: Optional[Callable[..., None]] = None
        self._pending_handoff: Deque = deque()  # (req, HandoffPayload)
        self._closed = False
        self._close_lock = locks.Lock("serving.decode_close")
        # zero-loss recovery state (serving.recovery)
        self._breaker = CircuitBreaker(
            failure_threshold=dconf.unhealthy_after,
            cooldown_s=dconf.breaker_cooldown_s,
            max_cooldown_s=dconf.breaker_max_cooldown_s)
        self._rescue_sink: Optional[Callable[..., int]] = None  # DecodeFleet
        self._consec_faults = 0
        self._recover_prev_delay = 0.0
        self._breaker_dirty = False
        self._journal: Optional[RequestJournal] = None
        # a DisaggRouter may swap in a journal SHARED across its workers;
        # then close()/kill() must not close it (the router owns its fd)
        self._journal_owned = True
        if dconf.journal_path:
            self._journal = RequestJournal(
                dconf.journal_path, fsync_every=dconf.journal_fsync_every,
                compact_bytes=dconf.journal_compact_bytes)
        self._rid_seq = itertools.count()
        self._killed = False
        self._drain_abort = False
        self._loop_trace: Optional[tracing.SpanContext] = None
        if tracing.tracing_enabled():
            self._loop_trace = tracing.SpanContext.new_trace()

        if dconf.warmup:
            self._warmup()
        self._thread = go(self._loop)

    # -- startup -----------------------------------------------------------

    def _place_group(self, params, cfg: dict, pshape, pages_per_slot: int):
        """Place one model on the group: each member's block of the
        parameters (the layout's), zero page tensors per member (split on
        the head dim where the layout shards it), and the group decoder
        over them. Returns ``(decoder, k_pages, v_pages)``."""
        group, layout = self._group, self._layout
        spec = layout.kv_page_spec(pshape, group.mesh)
        enforce(all(a is None for d, a in enumerate(spec) if d != KV_HEAD_DIM),
                f"DecodeEngine[{group.name}]: KV page spec {spec} shards a dim other than "
                f"the head dim ({KV_HEAD_DIM}); page ids and offsets are global across a group")
        kv_split = spec[KV_HEAD_DIM] is not None
        mshape = list(pshape)
        if kv_split:
            mshape[KV_HEAD_DIM] //= group.tp
        members = layout.shard_params(group, params)
        model = GroupPagedDecoder(members, {n: v.shape for n, v in params.items()}, cfg,
                                  self.decode_config.page_size, pages_per_slot, kv_split)
        k = [torch.zeros(mshape, dtype=self._cache_dtype, device=d) for d in group.devices]
        v = [torch.zeros(mshape, dtype=self._cache_dtype, device=d) for d in group.devices]
        return model, k, v

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self._device)

    def _sign(self, kind: str, *tensors) -> None:
        """Note one call's argument signature (a group's page lists count
        every member's page tensor)."""
        flat = [t for x in tensors for t in (x if isinstance(x, list) else [x])]
        self._signatures[kind].add(tuple((tuple(t.shape), t.dtype) for t in flat))

    def _synchronize(self) -> None:
        """Wait for every card this engine runs on."""
        for dev in self._model.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _warmup(self) -> None:
        """Run the prefill chunk and the decode step (and the draft and
        verify steps) once before traffic arrives, as the JAX package
        compiles them: the card's libraries initialize here, not in the
        first request's latency. Warmup writes land on the scratch page
        (zero tables), so no reset is needed afterwards."""
        dconf = self.decode_config
        S, P = dconf.max_slots, self._kv.pages_per_slot
        z = np.zeros((S,), np.int32)
        tables = self._dev(np.zeros((S, P), np.int32))
        chunk = self._dev(np.zeros((dconf.prefill_chunk,), np.int32))
        with torch.no_grad(), ieee_f32():
            self._prefill_call(chunk, 0, 0, tables[0])
            self._step_call(self._dev(z), self._dev(z), tables)
            if self._spec_k:
                self._draft_prefill(chunk, 0, 0, tables[0], self._dk_pages, self._dv_pages)
                self._draft_step(self._dev(z), self._dev(z), tables,
                                 self._dk_pages, self._dv_pages)
                self._verify_call(self._dev(np.zeros((S, self._spec_k + 1), np.int32)),
                                  self._dev(z), tables)
            if self._prefix is not None:
                self._copy_page(SCRATCH_PAGE, SCRATCH_PAGE)
        self._synchronize()

    def decode_step_cache_size(self) -> int:
        """Distinct argument signatures of the decode step seen so far: 1
        after warmup, and flat under traffic — continuous batching never
        changed the step's shapes (the JAX package counts compiled
        executables here)."""
        return len(self._signatures["step"])

    def prefill_cache_size(self) -> int:
        return len(self._signatures["prefill"])

    def verify_step_cache_size(self) -> int:
        """Distinct argument signatures of the verify step: 0 with
        speculation off, and 1 under mixed traffic — the block shape
        ``[max_slots, spec_tokens + 1]`` is static config."""
        return len(self._signatures["verify"])

    @property
    def kv(self) -> PagedKVCache:
        return self._kv

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def prefix(self) -> Optional[RadixPrefixCache]:
        """The engine's radix prefix cache (None unless
        ``DecodeConfig.prefix_cache`` is set)."""
        return self._prefix

    @property
    def spec_tokens(self) -> int:
        """Draft tokens proposed per verify iteration (0 = speculation
        off: no draft model configured)."""
        return self._spec_k

    @property
    def admission(self) -> Optional[admission_mod.AdmissionController]:
        return self._admission

    @property
    def breaker(self) -> CircuitBreaker:
        """This engine's health breaker: tripped on ``unhealthy_after``
        consecutive step faults."""
        return self._breaker

    @property
    def group(self) -> Optional[ReplicaGroup]:
        """The tp replica group backing this engine (None = the classic
        single-device mode)."""
        return self._group

    @property
    def tp_degree(self) -> int:
        """Tensor-parallel degree of the backing step (1 = single device).
        Stamped into handoff payloads so cross-group adoption with a
        DIFFERENT degree degrades to re-prefill instead of implanting pages
        computed by another partition of the step."""
        return self._group.tp if self._group is not None else 1

    def _manifest_name(self) -> str:
        """This engine's warm-up manifest identity (the JAX package's):
        model dims + the static decode-shape knobs, and ``_tp{n}`` for a
        group, whose step is another program than the single-device one."""
        d = self.decode_config
        mc = self.model_cfg
        name = "decode_L{l}_D{dm}_S{s}_P{p}_C{c}".format(
            l=mc.get("n_layers", 0), dm=mc.get("d_model", 0),
            s=d.max_slots, p=d.page_size, c=d.prefill_chunk)
        if self._group is not None:
            name += f"_tp{self._group.tp}"
        return name

    def load(self) -> float:
        """Live work on this engine: active slots plus every parked or
        queued request. ``DecodeFleet._pick`` routes new work to the
        least-loaded healthy engine by this number. Read lock-free from
        any thread — ``len()`` is atomic under the GIL, and staleness only
        costs routing optimality, never correctness."""
        return float(len(self._active) + len(self._resume)
                     + len(self._pending_admit)
                     + len(self._pending_handoff)
                     + self._queue.qsize())

    # -- the model calls ---------------------------------------------------

    def _prefill_call(self, chunk, pos0, last, table_row):
        self._sign("prefill", chunk, table_row, self._k_pages)
        return self._prefill(chunk, pos0, last, table_row, self._k_pages, self._v_pages)

    def _decode_and_sample(self, tokens, positions, tables, k_pages, v_pages):
        """The decode step and its sampling: the JAX package's jitted step."""
        dconf = self.decode_config
        logits = self._model.decode_step(tokens, positions, tables, k_pages, v_pages)
        return _sample(logits, dconf.temperature, dconf.top_k, dconf.top_p, self._gen)

    def _step_call(self, tokens, positions, tables):
        self._sign("step", tokens, positions, tables, self._k_pages)
        return self._step(tokens, positions, tables, self._k_pages, self._v_pages)

    def _verify_call(self, block, positions, tables):
        self._sign("verify", block, positions, tables, self._k_pages)
        return self._verify(block, positions, tables, self._k_pages, self._v_pages)

    def _copy_page(self, src: int, dst: int) -> None:
        """Device-side page copy for copy-on-write, in every page tensor
        (every member's, in a group)."""
        pages = [self._k_pages, self._v_pages]
        if self._spec_k:
            pages += [self._dk_pages, self._dv_pages]
        for p in pages:
            for t in (p if isinstance(p, list) else [p]):
                t[:, dst] = t[:, src]

    def _page_index(self, pages: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64)).to(self._device)

    def _member_pages(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The K and V page tensors, one per member (one on one device)."""
        return tuple(p if isinstance(p, list) else [p] for p in (self._k_pages, self._v_pages))

    def _gather_pages(self, pages: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V of physical ``pages``, each ``[n, L, H_kv, page_size,
        dh]`` (page ``i`` = ``[i]``), gathered on the engine's device by one
        ``index_select`` per page tensor: the handoff's and the demote's
        source, the JAX package's ``gather_kv_page`` for n pages at once.
        A group's pages are always whole logical pages: the members' head
        shards, concatenated in member order."""
        idx = self._page_index(pages)
        # pages whole on every member (replicated) are member 0's
        n = len(self._model.devices) if self._model.kv_split else 1

        def whole(members):
            parts = [t.index_select(1, idx.to(t.device)).to(self._device) for t in members[:n]]
            return (parts[0] if n == 1 else torch.cat(parts, KV_HEAD_DIM)).transpose(0, 1)

        k, v = self._member_pages()
        return whole(k), whole(v)

    def _implant_pages(self, pages: Sequence[int], k, v) -> None:
        """Write ``k``/``v`` (``[n, L, H_kv, page_size, dh]``, on any
        device, any float dtype) into physical ``pages`` by one
        ``index_copy_`` per page tensor (``scatter_kv_page`` of the JAX
        package for n pages); each member takes its heads."""
        idx = self._page_index(pages)
        for m, (kp, vp) in enumerate(zip(*self._member_pages())):
            lo, hi = self._model.kv_heads[m]
            dev = self._model.devices[m]
            for dst, src in ((kp, k), (vp, v)):
                part = src.narrow(2, lo, hi - lo)  # [n, L, H_kv, page_size, dh]
                dst.index_copy_(1, idx.to(dev), part.to(dev, self._cache_dtype).transpose(0, 1))

    # -- admission cost ----------------------------------------------------

    def _n_chunks(self, length: int) -> int:
        return max(1, -(-length // self.decode_config.prefill_chunk))

    def _request_cost(self, req) -> Optional[float]:
        """Per-token deadline prediction for the admission controller:
        chunks x chunk-EMA + max_new_tokens x step-EMA, plus the queued
        work ahead priced in iterations."""
        queued = self._queue.qsize() + len(self._pending_admit)
        return self.cost.estimate(
            self._n_chunks(len(req.prompt)), req.mnt, queue_cost=queued)

    # -- request intake ----------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
        tenant: Optional[str] = None,
        cls: Optional[str] = None,
    ) -> DecodeHandle:
        """Enqueue one generation request. ``prompt`` is a 1-D int token
        array; the result is a :class:`DecodeOutput` via the returned
        handle. With admission on, an infeasible or over-quota request
        raises :class:`AdmissionRejected`; without it, a full queue blocks
        up to ``timeout``."""
        if self._closed:
            raise EngineClosedError("engine is closed")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        dconf = self.decode_config
        enforce(prompt.size >= 1, "prompt must be non-empty")
        enforce(max_new_tokens >= 1,
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        enforce(
            int(prompt.size) + max_new_tokens <= dconf.max_context,
            f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_context ({dconf.max_context})")
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.record_timeout()
            raise DeadlineExceeded(
                f"deadline {deadline_s}s already expired at submit")
        deadline = None if deadline_s is None else now + deadline_s
        tname = tenant if tenant is not None else self._default_tenant
        tcfg = self._tenants.get(tname)
        rcls = cls if cls is not None else (
            tcfg.default_class if tcfg is not None
            else cfg_mod.flags().tenant_default_class)
        enforce(rcls in sched_mod.CLASSES,
                f"unknown priority class {rcls!r} "
                f"(expected one of {sched_mod.CLASSES})")
        if self._admission is None:
            enforce(tcfg is not None,
                    f"unknown tenant {tname!r} "
                    f"(configured: {sorted(self._tenants)})")
        req = _DecodeRequest(prompt, int(max_new_tokens),
                             self._n_chunks(int(prompt.size)),
                             deadline, now, tenant=tname, cls=rcls)
        req.rid = self._new_rid()
        if tracing.tracing_enabled():
            req.trace = tracing.SpanContext.new_trace()
            req.handle.trace = req.trace
            req.t_enqueue_pc = time.perf_counter()
        # token-latency waterfall opens at submit: TTFT includes queue wait
        waterfall.start(req.rid, time.perf_counter(),
                        engine=self.metrics.engine_label, tenant=req.tenant,
                        cls=req.cls)
        # journal BEFORE enqueue: the loop may start generating (and
        # journaling tokens) the instant the scheduler has the request
        self._j_admit(req)
        try:
            if self._admission is not None:
                self._admission.admit(req)
            else:
                self._queue.send(req, timeout=timeout)
        except ChannelClosedError:
            self._j_fin(req, "shed")
            waterfall.finish(req.rid, time.perf_counter(), "shed")
            raise EngineClosedError("engine is closed") from None
        except (AdmissionRejected, TimeoutError):
            self._j_fin(req, "shed")
            waterfall.finish(req.rid, time.perf_counter(), "shed")
            self._finish_trace(req, time.perf_counter(), status="shed")
            raise
        self.metrics.record_submit()
        return req.handle

    def infer(self, prompt, max_new_tokens: int, **kwargs) -> DecodeOutput:
        """Synchronous decode: submit + wait."""
        return self.submit(prompt, max_new_tokens, **kwargs).result()

    def _new_rid(self) -> str:
        return f"{self.metrics.engine_label}-{_RID_SALT}-{next(self._rid_seq)}"

    # -- journal hooks (no-ops with journaling off) ------------------------

    def _j_admit(self, req: _DecodeRequest) -> None:
        if self._journal is not None and req.rid is not None:
            self._journal.log_admit(req.rid, req.prompt, req.mnt,
                                    req.generated, req.tenant, req.cls,
                                    trace=(req.trace.to_traceparent()
                                           if req.trace is not None
                                           else None))
            self.metrics.record_journal_records(1)

    def _j_tok(self, req: _DecodeRequest, tok: int) -> None:
        if self._journal is not None and req.rid is not None:
            self._journal.log_token(req.rid, tok)
            self.metrics.record_journal_records(1)

    def _j_fin(self, req: _DecodeRequest, reason: str) -> None:
        if self._journal is not None and req.rid is not None:
            self._journal.log_finish(req.rid, reason)
            self.metrics.record_journal_records(1)

    # -- completion paths (loop thread, except _expire) --------------------

    def _finish_trace(self, req: _DecodeRequest, t1_pc: float,
                      **attrs) -> None:
        if req.trace is None:
            return
        tracing.record_span(
            "serving.decode.request", req.t_enqueue_pc, t1_pc,
            context=req.trace, engine=self.metrics.engine_label,
            tenant=req.tenant, cls=req.cls,
            generated=len(req.generated), **attrs)

    def _wf_tokens(self, req: _DecodeRequest, t_pc: float, n: int,
                   phase: str) -> None:
        """Book ``n`` tokens landing at ``t_pc`` in the request's
        waterfall and mirror the returned TTFT / per-token TPOT samples
        into the labeled histogram families. Called BEFORE the tokens are
        appended — an append can finish the request, and a finished
        waterfall refuses further bookings."""
        ttft, samples = waterfall.on_tokens(req.rid, t_pc, n, phase=phase)
        if ttft is not None:
            self.metrics.record_ttft(ttft, cls=req.cls)
        if samples:
            self.metrics.record_tpot(samples, cls=req.cls)

    def _expire(self, req: _DecodeRequest) -> None:
        """Deadline lapsed while queued (scheduler callback) or mid-
        generation (loop check)."""
        self.metrics.record_timeout()
        self.metrics.record_evict("deadline")
        self._j_fin(req, "deadline")
        waterfall.finish(req.rid, time.perf_counter(), "deadline")
        self._finish_trace(req, time.perf_counter(),
                           status="deadline_exceeded")
        req.handle._fail(DeadlineExceeded(
            f"request expired after "
            f"{time.monotonic() - req.t_submit:.3f}s "
            f"({len(req.generated)}/{req.mnt} tokens generated)"))

    def _release(self, req: _DecodeRequest) -> None:
        if req.slot is not None:
            self._kv.release_slot(req.slot)
            req.slot = None
        if req in self._active:
            self._active.remove(req)

    def _finish(self, req: _DecodeRequest, reason: str) -> None:
        self._release(req)
        self._j_fin(req, reason)
        self.metrics.record_evict(reason)
        if reason == "cancelled":
            self.metrics.record_cancel()
        self.metrics.record_response(time.monotonic() - req.t_submit)
        waterfall.finish(req.rid, time.perf_counter(), reason)
        self._finish_trace(req, time.perf_counter(), status=reason)
        runlog.emit("decode_evict", reason=reason, tenant=req.tenant,
                    generated=len(req.generated),
                    engine=self.metrics.engine_label)
        req.handle._complete(DecodeOutput(
            tokens=np.asarray(req.generated, dtype=np.int32),
            finish_reason=reason,
            prompt_len=int(req.prompt.size),
            n_preemptions=req.n_preemptions))

    def _fail(self, req: _DecodeRequest, exc: BaseException) -> None:
        self._release(req)
        self._j_fin(req, "error")
        self.metrics.record_error()
        self.metrics.record_evict("error")
        waterfall.finish(req.rid, time.perf_counter(), "error")
        self._finish_trace(req, time.perf_counter(), status="error",
                           error=type(exc).__name__)
        req.handle._fail(exc)

    # -- the decode loop ---------------------------------------------------

    def _loop(self) -> None:
        try:
            # grad mode is thread-local: without this every step would
            # record an autograd graph through the parameters
            with torch.no_grad():
                self._loop_body()
        except BaseException as e:  # fail everything rather than hang
            ptlog.error("decode loop died: %r", e)
            for req in (list(self._active) + list(self._resume)
                        + list(self._pending_admit)
                        + [item[0] for item in self._pending_handoff]):
                try:
                    self._fail(req, RuntimeError(f"decode loop died: {e!r}"))
                except Exception:
                    pass
            raise

    def _loop_body(self) -> None:
        dconf = self.decode_config
        while True:
            if self._killed:
                return  # abrupt death: kill() resolves the handles
            if self._drain_abort:
                self._force_drain()
                break
            self._sweep_cancel_deadline()
            self._probe_group()
            self._admit_handoffs()
            self._admit()
            t0 = time.perf_counter()
            did_promote = self._apply_promotes()
            did_prefill = self._prefill_some()
            did_step = self._decode_step()
            if did_prefill or did_step or did_promote:
                self.metrics.set_pages(self._kv.pages_in_use,
                                       self._kv.pages_free)
                self.metrics.set_active_slots(len(self._active))
                self.metrics.set_load(self.load())
                self.metrics.set_queue_depth(self._queue.qsize())
                self._publish_digest()
                if self._loop_trace is not None:
                    tracing.record_span(
                        "serving.decode.step", t0, time.perf_counter(),
                        parent=self._loop_trace,
                        active=len(self._active))
                continue
            # idle: nothing to prefill or step — wait for work or drain out
            if (self._active or self._resume or self._pending_admit
                    or self._pending_handoff):
                continue
            try:
                req, ok = self._queue.recv(timeout=dconf.idle_poll_s)
            except TimeoutError:
                continue
            if not ok:
                break  # closed AND drained, nothing in flight
            self._pending_admit.append(req)
        if self._prefix is not None:
            self._prefix.clear()  # drained: drop the tree's page refs
        self._promote_jobs.clear()
        self._promote_keys.clear()
        self._publish_digest()  # tree gone: publish the empty digest
        self.metrics.set_active_slots(0)
        self.metrics.set_pages(self._kv.pages_in_use, self._kv.pages_free)

    def _sweep_cancel_deadline(self) -> None:
        now = time.monotonic()
        for req in list(self._active):
            if req.cancelled:
                self._finish(req, "cancelled")
            elif req.deadline is not None and now > req.deadline:
                self._release(req)
                self._expire(req)
        for pool in (self._resume, self._pending_admit):
            for req in list(pool):
                if req.cancelled:
                    pool.remove(req)
                    self._finish(req, "cancelled")
                elif req.deadline is not None and now > req.deadline:
                    pool.remove(req)
                    self._expire(req)
        for item in list(self._pending_handoff):
            req = item[0]
            if req.cancelled:
                self._pending_handoff.remove(item)
                self._finish(req, "cancelled")
            elif req.deadline is not None and now > req.deadline:
                self._pending_handoff.remove(item)
                self._expire(req)

    def _admit(self) -> None:
        """Fill free slots: preempted requests first (front of line), then
        parked arrivals, then fresh pops from the scheduler. A request
        that cannot get a slot parks; pages are granted lazily at
        prefill/step time."""
        while len(self._active) < self.decode_config.max_slots:
            resumed = False
            if self._resume:
                req = self._resume.popleft()
                resumed = True
            elif self._pending_admit:
                req = self._pending_admit.popleft()
            else:
                try:
                    req, ok = self._queue.recv(timeout=0)
                except TimeoutError:
                    return
                if not ok:
                    return  # closed and drained
            if req.cancelled:
                self._finish(req, "cancelled")
                continue
            slot = self._kv.acquire_slot()
            if slot is None:  # raced vs max_slots accounting; park
                (self._resume if resumed
                 else self._pending_admit).appendleft(req)
                return
            req.slot = slot
            req.phase = "prefill"
            req.seq = (np.concatenate([req.prompt,
                                       np.asarray(req.generated, np.int32)])
                       if req.generated else req.prompt)
            req.chunks_done = 0
            self._maybe_prefix_adopt(req)
            req.t_admit_pc = time.perf_counter()
            self._active.append(req)
            if resumed:
                self.metrics.record_resume()
                runlog.emit("decode_resume", tenant=req.tenant,
                            generated=len(req.generated),
                            engine=self.metrics.engine_label)
            else:
                self.metrics.record_slot_admit()
                runlog.emit("decode_admit", tenant=req.tenant,
                            prompt_len=int(req.prompt.size), mnt=req.mnt,
                            engine=self.metrics.engine_label)
                if req.trace is not None:
                    tracing.record_span(
                        "serving.decode.queue_wait", req.t_enqueue_pc,
                        req.t_admit_pc, parent=req.trace,
                        engine=self.metrics.engine_label)

    def _admit_handoffs(self) -> None:
        """Admit handed-off requests (serving.disagg): implant the
        transferred KV pages into this engine's page arrays and enter the
        decode phase directly — no re-prefill. Any failure (geometry
        mismatch, page-pool pressure, implant error) degrades to the
        resume path, which re-prefills ``prompt + generated``
        token-exactly — a bad transfer costs latency, never a request."""
        dconf = self.decode_config
        page_shape = self._page_shape
        while (self._pending_handoff
               and len(self._active) < dconf.max_slots):
            req, payload = self._pending_handoff.popleft()
            if req.cancelled:
                self._finish(req, "cancelled")
                continue
            slot = self._kv.acquire_slot()
            if slot is None:  # raced vs max_slots accounting; park
                self._pending_handoff.appendleft((req, payload))
                return
            req.slot = slot
            n_pages = -(-int(payload.cur_len) // dconf.page_size)
            t0_adopt = time.perf_counter()
            ok = False
            # a draft model keeps its own page arrays, which the payload
            # does not carry — re-prefill fills both caches correctly. A
            # payload gathered under a DIFFERENT tp degree ran a different
            # partitioned program; adopting its pages verbatim would
            # splice two programs' numerics mid-sequence, so cross-degree
            # adoption degrades to re-prefill.
            if (not self._spec_k
                    and int(getattr(payload, "tp_degree", 1)) == self.tp_degree
                    and payload.page_size == dconf.page_size
                    and 0 < payload.cur_len <= dconf.max_context
                    and len(payload.k_pages) == n_pages
                    and len(payload.v_pages) == n_pages
                    and all(tuple(p.shape) == page_shape for p in
                            itertools.chain(payload.k_pages, payload.v_pages))):
                try:
                    if self._ensure_pages(req, int(payload.cur_len)):
                        k, v = _page_stack(payload.k_pages), _page_stack(payload.v_pages)
                        ready = getattr(payload, "ready", None)
                        if ready is not None:
                            # the gather ran on the publisher's stream:
                            # order the implant after it, and keep its
                            # memory alive until this stream has read it
                            stream = torch.cuda.current_stream(self._device)
                            stream.wait_event(ready)
                            for t in (k, v):
                                if t.device.type == "cuda":
                                    t.record_stream(stream)
                        self._implant_pages(
                            self._kv.page_tables[req.slot][:n_pages], k, v)
                        ok = True
                except Exception as e:
                    ptlog.warning(
                        "handoff page adoption failed (%r); "
                        "re-prefilling request %s", e, req.rid)
            if not ok:
                self._release(req)
                self._requeue(req)
                self.metrics.record_recover(1)
                continue
            # the adopted pages cover positions [0, cur_len); last_tok is
            # the token pending its KV write — exactly mid-decode state
            req.seq = None
            req.phase = "decode"
            req.cur_len = int(payload.cur_len)
            req.chunks_done = self._n_chunks(
                int(req.prompt.size) + len(req.generated))
            req.last_tok = int(payload.last_tok)
            self._kv.seq_lens[req.slot] = req.cur_len
            req.t_admit_pc = time.perf_counter()
            self._active.append(req)
            self.metrics.record_handoff_in()
            self.metrics.record_slot_admit()
            if req.trace is not None:
                tracing.record_span(
                    "serving.handoff.adopt", t0_adopt, time.perf_counter(),
                    parent=req.trace, engine=self.metrics.engine_label,
                    from_engine=payload.src, pages=n_pages, rid=req.rid)
            runlog.emit("handoff_adopted", rid=req.rid,
                        from_engine=payload.src, pages=n_pages,
                        engine=self.metrics.engine_label)

    def _maybe_prefix_adopt(self, req: _DecodeRequest) -> None:
        """Consult the radix prefix cache at slot assignment: adopt the
        longest cached page run of ``req.seq`` (capped at ``len(seq)-1`` —
        the final token must always prefill so its logits seed the first
        generated token) and skip the prefill chunks it fully covers.
        When the hit boundary is not chunk-aligned, the continuation chunk
        would write into shared pages, so the straddled pages are
        copied-on-write first (device-side page copy; the chunk then
        rewrites the straddled span with identical values into the private
        pages). If the pool cannot supply the CoW pages, the hit shrinks
        to the chunk-aligned boundary instead — never a partial adopt."""
        if self._prefix is None:
            return
        self.metrics.record_prompt_tokens(len(req.seq))
        ps = self.decode_config.page_size
        C = self.decode_config.prefill_chunk
        max_pages = min((len(req.seq) - 1) // ps, self._kv.pages_per_slot)
        if max_pages <= 0:
            return
        pages = self._prefix.match(req.seq, max_pages)
        m = len(pages)
        # hierarchical KV: the tree's true depth (pre-CoW-shrink) is the
        # promote frontier — when the host tier holds the NEXT page of
        # this prefix, enqueue an async promote so the next same-prefix
        # request hits on the card. THIS request prefills as usual either
        # way (token-exact regardless of promotion timing).
        if (self._host_tier is not None and m < max_pages
                and self._host_tier.contains(req.seq, m + 1)):
            self._host_request_promote(req.seq, max_pages, trace=req.trace)
        while m > 0:
            c0 = (m * ps) // C
            lo = (c0 * C) // ps  # first logical page the next chunk touches
            n_cow = 0 if (m * ps) % C == 0 else m - lo
            if n_cow == 0 or self._kv.allocator.num_free >= n_cow:
                break
            m = lo  # drop the straddled tail; strictly decreasing
        if m <= 0:
            return
        self._kv.adopt_pages(req.slot, pages[:m])
        c0 = (m * ps) // C
        cow_done = 0
        if (m * ps) % C != 0:
            for li in range((c0 * C) // ps, m):
                src, dst = self._kv.private_copy(req.slot, li)
                self._copy_page(src, dst)
                cow_done += 1
        req.chunks_done = c0
        self._kv.seq_lens[req.slot] = m * ps
        if cow_done:
            self.metrics.record_cow(cow_done)
        self.metrics.record_prefix_hit(m * ps, saved_chunks=c0)
        runlog.emit("decode_prefix_hit", hit_tokens=m * ps,
                    saved_chunks=c0, cow=cow_done,
                    engine=self.metrics.engine_label)

    # -- hierarchical KV host tier (serving.host_tier) ---------------------

    def _host_demote(self, req: _DecodeRequest, n_full: int) -> None:
        """Write-through demote: copy ``req``'s first ``n_full`` fully-
        written pages off the card and store them in the host tier. Called
        on the loop thread right after the radix insert, while the tree
        holds refs — the pages are immutable and cannot be recycled under
        a stale key. The pages not yet in the pool come over in one
        ``index_select`` and one copy to the host per page array. Also the
        crash-recovery write: with a SHARED pool, these bytes outlive this
        engine's kill()."""
        if self._host_tier is None:
            return
        pages = self._kv.slot_pages(req.slot)[:n_full]
        wrote = 0
        bp = 0
        t0_demote = time.perf_counter()
        try:
            todo = [i for i in range(len(pages))
                    if not self._host_tier.contains(req.seq, i + 1)]  # dedup
            if todo:
                k, v = self._gather_pages([pages[i] for i in todo])
                k, v = k.contiguous().cpu(), v.contiguous().cpu()
                for j, i in enumerate(todo):
                    res = self._host_tier.put(
                        req.seq, i, k[j], v[j], engine=self.metrics.engine_label)
                    wrote += res["added"]
                    if res["evicted"]:
                        bp += 1
        except Exception as e:
            # demote is strictly best-effort: an injected stall/error (or
            # real host-memory pressure) must never fail the request —
            # the page simply stays device-only
            ptlog.warning("host-tier demote failed: %r; page stays "
                          "device-only", e)
        if wrote:
            self.metrics.record_host_demote(wrote)
            if req.trace is not None:
                tracing.record_span(
                    "serving.host_tier.demote", t0_demote,
                    time.perf_counter(), parent=req.trace,
                    engine=self.metrics.engine_label, pages=wrote)
        if bp:
            self.metrics.record_host_backpressure(bp)
        self.metrics.set_host_tier_bytes(self._host_tier.bytes_used,
                                         self._host_tier.max_bytes)

    def _host_request_promote(self, seq: np.ndarray, want_pages: int,
                              trace=None) -> None:
        """Enqueue an async promote of this prefix up to ``want_pages``
        pages; dedup by prefix digest so a storm of same-prefix requests
        enqueues one job. The hit is counted HERE (the routing-visible
        event), not at apply time. ``trace`` is the enqueueing request's
        span context — the applied promote parents its span there."""
        ps = self.decode_config.page_size
        toks = np.asarray(seq[:want_pages * ps], np.int32)
        key = zlib.crc32(toks.tobytes()) & 0xFFFFFFFF
        if key in self._promote_keys:
            return
        self._promote_keys.add(key)
        self._promote_jobs.append((key, toks, want_pages, trace))
        self.metrics.record_host_hit()

    def _apply_promotes(self) -> bool:
        """Apply queued host-tier promotions on the loop thread, at most
        ``host_promote_pages_per_iter`` pages per iteration — off the
        request path (the enqueueing request prefilled normally) and
        bounded so promotion stays decode-latency-neutral.

        Each application re-checks the tree (``peek``) because the job
        may be stale: a concurrent admission may have prefilled the
        prefix already, or eviction may have shortened it since enqueue.
        Page ownership follows the loader-handoff discipline documented
        on ``PageAllocator.refcounts``: alloc (ref 1) → implant →
        ``insert`` refs for the tree (→ 2) → free the loader ref (→ 1,
        tree-owned). A CRC failure quarantines the host page and drops
        the job — the prefix simply stays cold and re-prefills."""
        if self._host_tier is None or not self._promote_jobs:
            return False
        ps = self.decode_config.page_size
        budget = self.decode_config.host_promote_pages_per_iter
        did = False
        while budget > 0 and self._promote_jobs:
            key, toks, want, job_trace = self._promote_jobs.popleft()
            if self._prefix.max_pages is not None:
                # promoting past the tree's own size cap is wasted motion:
                # the insert would be trimmed right back out
                want = min(want, self._prefix.max_pages)
            tree_pages = self._prefix.peek(toks, want)
            d = len(tree_pages)
            if d >= want:  # stale: someone prefilled it meanwhile
                self._promote_keys.discard(key)
                continue
            t0 = time.perf_counter()
            try:
                got = self._host_tier.get(
                    toks, d, engine=self.metrics.engine_label)
            except HostPageCorrupt:
                # bit-flipped host page: quarantined by the pool; the
                # prefix stays cold and the next request re-prefills
                # token-exactly instead of trusting it
                self.metrics.record_host_quarantine()
                self._promote_keys.discard(key)
                continue
            except Exception as e:
                ptlog.warning("host-tier promote read failed: %r", e)
                self._promote_keys.discard(key)
                continue
            if got is None:  # evicted from the pool since enqueue
                self._promote_keys.discard(key)
                continue
            alloced = self._kv.allocator.alloc(1)
            if alloced is None:
                # never steal device pages from live traffic for a
                # warm-ahead; drop the job — the next admission re-probes
                self._promote_keys.discard(key)
                continue
            page = alloced[0]
            self._implant_pages([page], got[0][None], got[1][None])
            self._prefix.insert(toks[:(d + 1) * ps], tree_pages + [page])
            self._kv.allocator.free([page])  # hand ownership to the tree
            budget -= 1
            did = True
            t1 = time.perf_counter()
            self.metrics.record_host_promote(t1 - t0)
            parent = job_trace if job_trace is not None else self._loop_trace
            if parent is not None:
                tracing.record_span(
                    "serving.host_tier.promote", t0, t1, parent=parent,
                    engine=self.metrics.engine_label, page=d)
            # progress guard: the insert can be trimmed straight back out
            # (size-cap eviction, allocator pressure). Re-enqueue only on
            # real depth growth — otherwise a capped tree and a warm pool
            # would promote-evict-promote forever and the loop never idles
            nd = len(self._prefix.peek(toks, want))
            if d < nd < want and self._host_tier.contains(toks, nd + 1):
                self._promote_jobs.append((key, toks, want, job_trace))
            else:
                self._promote_keys.discard(key)
        if did:
            self.metrics.set_pages(self._kv.pages_in_use,
                                   self._kv.pages_free)
        return did

    def _publish_digest(self) -> None:
        """Republish the routing digest when the tree changed. Loop-thread
        only; readers (DecodeFleet._pick, any thread) see an immutable
        frozenset swapped atomically under the GIL."""
        if not self.decode_config.prefix_digest or self._prefix is None:
            return
        v = self._prefix.digest_version
        if v != self._digest_seen:
            self._digest_seen = v
            self._digest_pub = self._prefix.digests()

    def prefix_digest(self) -> frozenset:
        """The engine's published prefix-digest set (empty unless
        ``DecodeConfig.prefix_digest``). Lock-free snapshot."""
        return self._digest_pub

    def prefix_match_depth(self, digests: List[int]) -> int:
        """Longest prefix (in pages) of a prompt's digest chain (from
        :func:`serving.host_tier.prefix_digests`) this engine has cached.
        The routing score: fleets send each prompt to the deepest match."""
        pub = self._digest_pub
        depth = 0
        for dg in digests:
            if dg not in pub:
                break
            depth += 1
        return depth

    @property
    def host_tier(self) -> Optional[HostPagePool]:
        """The engine's host-RAM page pool (shared or private; None when
        the tier is off)."""
        return self._host_tier

    def _ensure_pages(self, req: _DecodeRequest, n_positions: int) -> bool:
        """Grow ``req``'s slot to ``n_positions``, evicting prefix-cache
        pages first and then preempting the most recently admitted OTHER
        request (LIFO) while the pool is short. The kv-cache deadlock
        guard guarantees a lone request can always grow to max_context
        once the tree is drained, so this terminates."""
        while not self._kv.ensure_capacity(req.slot, n_positions):
            if self._prefix is not None and self._prefix.evict(1) > 0:
                continue  # tree pages are cheaper to reclaim than preempts
            victim = next((r for r in reversed(self._active) if r is not req),
                          None)
            if victim is None:  # unreachable per the pool-size guard
                self._fail(req, RuntimeError(
                    "page pool exhausted with no preemption victim"))
                return False
            self._preempt(victim)
        return True

    def _requeue(self, req: _DecodeRequest) -> None:
        """Back to the front of the line: re-prefill ``prompt +
        generated`` from host state when it is admitted again."""
        req.phase = "queued"
        req.seq = None
        req.chunks_done = 0
        req.cur_len = 0
        self._resume.append(req)

    def _preempt(self, victim: _DecodeRequest) -> None:
        """Evict ``victim`` on page exhaustion, keeping its generated
        prefix — greedy decode continues identically."""
        freed = self._kv.slot_page_count(victim.slot)
        self._release(victim)
        victim.n_preemptions += 1
        self._requeue(victim)
        self.metrics.record_preempt()
        runlog.emit("decode_preempt", tenant=victim.tenant,
                    generated=len(victim.generated), pages_freed=freed,
                    engine=self.metrics.engine_label)

    def _append_token(self, req: _DecodeRequest, tok: int) -> None:
        """Host-side finish checks for one sampled token."""
        req.generated.append(tok)
        self._j_tok(req, tok)
        eos = self.decode_config.eos_id
        if eos is not None and tok == eos:
            self._finish(req, "eos")
        elif len(req.generated) >= req.mnt:
            self._finish(req, "length")
        else:
            req.last_tok = tok

    def _prefill_some(self) -> bool:
        """Run up to ``prefill_chunks_per_iter`` chunks across prefill-
        phase requests (oldest first)."""
        dconf = self.decode_config
        budget = dconf.prefill_chunks_per_iter
        progressed = False
        for req in list(self._active):
            if budget <= 0:
                break
            if req.phase != "prefill":
                continue
            C = dconf.prefill_chunk
            c = req.chunks_done
            n_chunks = self._n_chunks(len(req.seq))
            chunk_end = (c + 1) * C
            if not self._ensure_pages(req, min(chunk_end, len(req.seq))):
                continue
            chunk = np.zeros((C,), np.int32)
            seg = req.seq[c * C:min((c + 1) * C, len(req.seq))]
            chunk[:len(seg)] = seg
            last = max(len(req.seq) - 1 - c * C, 0)
            last_chunk = c == n_chunks - 1
            t0 = time.perf_counter()
            try:
                with ieee_f32():
                    table_row = self._dev(self._kv.page_tables[req.slot])
                    chunk_dev = self._dev(chunk)
                    logits = self._prefill_call(chunk_dev, c * C, last, table_row)
                    if self._spec_k:
                        # the draft's cache must cover the same prefix so
                        # its proposals attend real context
                        self._draft_prefill(chunk_dev, c * C, last, table_row,
                                            self._dk_pages, self._dv_pages)
                    tok = int(_sample(logits[None], dconf.temperature, dconf.top_k,
                                      dconf.top_p, self._gen)[0]) if last_chunk else 0
            except Exception as e:
                self._recover_request(req, e)
                continue
            t1 = time.perf_counter()
            self.metrics.record_prefill_chunk(t1 - t0)
            self.cost.observe_chunk(t1 - t0)
            if req.trace is not None:
                tracing.record_span("serving.decode.prefill", t0, t1,
                                    parent=req.trace, chunk=c,
                                    engine=self.metrics.engine_label)
            req.chunks_done = c + 1
            self._kv.seq_lens[req.slot] = min(chunk_end, len(req.seq))
            budget -= 1
            progressed = True
            if last_chunk:
                if self._prefix is not None:
                    # every fully-written page is immutable from here on
                    # (decode writes land past len(seq)) — publish them
                    n_full = len(req.seq) // dconf.page_size
                    if n_full:
                        self._prefix.insert(
                            req.seq, self._kv.slot_pages(req.slot)[:n_full])
                        # write-through demote: the same immutable pages,
                        # while the tree holds refs (no recycle race)
                        self._host_demote(req, n_full)
                req.phase = "decode"
                req.cur_len = len(req.seq)
                # the final chunk's sample IS the next token after the
                # prefilled sequence
                self._wf_tokens(req, t1, 1, "prefill")
                self._append_token(req, tok)
                # prefill role (serving.disagg): publish instead of
                # decoding here — unless that one sampled token already
                # finished the request (it left _active via _finish).
                # Draft-model engines keep their work local: the payload
                # carries only the target cache.
                if (self._handoff_sink is not None and not self._spec_k
                        and req in self._active):
                    self._publish_handoff(req)
        return progressed

    def _decode_step(self) -> bool:
        """One decode iteration: with a draft model configured, slots with
        headroom for a full ``spec_tokens + 1`` block go through the
        draft-and-verify path; the rest (within ``spec_tokens`` positions
        of ``max_context``) fall back to the plain one-token step, which
        is always exact. Both substeps keep the scratch-page discipline:
        uninvolved slots get scratch table rows and position 0."""
        did = False
        handled: set = set()
        if self._spec_k:
            limit = self.decode_config.max_context - self._spec_k - 1
            spec = [r for r in self._active
                    if r.phase == "decode" and r.cur_len <= limit]
            if spec:
                handled = {id(r) for r in spec}
                did = self._verify_decode_step(spec) or did
        rest = [r for r in self._active
                if r.phase == "decode" and id(r) not in handled]
        if rest:
            did = self._plain_decode_step(rest) or did
        return did

    def _grow_for_step(self, reqs: List[_DecodeRequest], extra: int) -> List[_DecodeRequest]:
        """Grant each request the pages for ``extra`` more positions; the
        requests still active afterwards (a grow may preempt an earlier
        one as its victim)."""
        for req in list(reqs):
            if req in self._active:
                self._ensure_pages(req, req.cur_len + extra)
        return [r for r in reqs if r in self._active]

    def _step_inputs(self, reqs: List[_DecodeRequest]):
        """Host arrays of one step: each request's last token, position and
        page table in its slot; idle and mid-prefill slots get token 0,
        position 0 and a scratch table row, so their writes land on the
        scratch page and their outputs are ignored."""
        S = self.decode_config.max_slots
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        tables = np.full((S, self._kv.pages_per_slot), SCRATCH_PAGE, np.int32)
        for req in reqs:
            tokens[req.slot] = req.last_tok
            positions[req.slot] = req.cur_len
            tables[req.slot] = self._kv.page_tables[req.slot]
        return tokens, positions, tables

    def _step_failed(self, e: Exception, what: str) -> None:
        if self.decode_config.recovery:
            self._recover_step_fault(e)
            return
        runlog.emit("decode_step_error", error=repr(e),
                    engine=self.metrics.engine_label)
        ptlog.error("%s failed: %r", what, e)
        for req in list(self._active):
            self._fail(req, e)

    def _plain_decode_step(self, decoding: List[_DecodeRequest]) -> bool:
        """One iteration over the given decode-phase slots."""
        decoding = self._grow_for_step(decoding, 1)
        if not decoding:
            return False
        tokens, positions, tables = self._step_inputs(decoding)
        t0 = time.perf_counter()
        try:
            faults.inject(faults.DECODE_STEP, engine=self.metrics.engine_label)
            with ieee_f32():
                nxt = self._step_call(self._dev(tokens), self._dev(positions),
                                      self._dev(tables))
                nxt = nxt.cpu().numpy()
        except Exception as e:
            self._step_failed(e, "decode step")
            return True
        t1 = time.perf_counter()
        self._note_step_ok()
        S = self.decode_config.max_slots
        self.metrics.record_step(len(decoding), S, t1 - t0, len(decoding))
        self.cost.observe_step(t1 - t0)
        for req in decoding:
            req.cur_len += 1
            self._kv.seq_lens[req.slot] = req.cur_len
            self._wf_tokens(req, t1, 1, "decode")
            self._append_token(req, int(nxt[req.slot]))
        return True

    def _verify_decode_step(self, spec: List[_DecodeRequest]) -> bool:
        """One draft-and-verify iteration: K sequential draft steps
        propose a block, one verify step scores all K+1 positions against
        the target's paged cache, and each slot accepts the longest draft
        prefix matching the target's own greedy argmaxes plus the bonus
        token — at least 1, at most K+1 tokens per slot per iteration,
        token-exact vs sequential decode.

        Rollback is host-side only: rejected positions sit past the
        accepted frontier, masked until the next block overwrites them
        (both caches), so :meth:`PagedKVCache.trim` just returns the
        surplus pages granted for the block."""
        K = self._spec_k
        spec = self._grow_for_step(spec, K + 1)
        if not spec:
            return False
        tokens, positions, tables = self._step_inputs(spec)
        t0 = time.perf_counter()
        try:
            faults.inject(faults.DECODE_STEP, engine=self.metrics.engine_label)
            with ieee_f32():
                tables_d, pos_d, cur = self._dev(tables), self._dev(positions), self._dev(tokens)
                cols = [cur]
                for j in range(K):
                    logits = self._draft_step(cols[-1], pos_d + j, tables_d,
                                              self._dk_pages, self._dv_pages)
                    cols.append(torch.argmax(logits, -1).to(torch.int32))
                block = torch.stack(cols, 1)  # [S, K+1]
                out = self._verify_call(block, pos_d, tables_d)
                both = torch.cat([block[:, 1:], out], 1).cpu().numpy()
        except Exception as e:
            self._step_failed(e, "verify step")
            return True
        draft_mat, out = both[:, :K], both[:, K:]
        t1 = time.perf_counter()
        self._note_step_ok()
        new_tokens = 0
        drafts_accepted = 0
        eos = self.decode_config.eos_id
        for req in spec:
            row = out[req.slot]
            n_acc = 0
            while n_acc < K and int(draft_mat[req.slot, n_acc]) == int(row[n_acc]):
                n_acc += 1
            drafts_accepted += n_acc
            # waterfall booking mirrors _append_token's finish conditions:
            # the block truncates at eos / budget, and the n tokens this
            # iteration lands book n TPOT samples of dt/n
            n_land = min(n_acc + 1, req.mnt - len(req.generated))
            if eos is not None:
                for j in range(n_land):
                    if int(row[j]) == eos:
                        n_land = j + 1
                        break
            self._wf_tokens(req, t1, n_land, "verify")
            for j in range(n_acc + 1):
                if req not in self._active:
                    break  # finished (eos / budget) mid-block
                req.cur_len += 1
                self._kv.seq_lens[req.slot] = req.cur_len
                self._append_token(req, int(row[j]))
                new_tokens += 1
            if req in self._active:
                # roll back pages granted for rejected draft positions
                self._kv.trim(req.slot, req.cur_len)
        S = self.decode_config.max_slots
        self.metrics.record_verify_step(
            len(spec), S, t1 - t0, new_tokens,
            drafts_proposed=len(spec) * K, drafts_accepted=drafts_accepted)
        self.cost.observe_verify(t1 - t0, new_tokens / len(spec))
        if self._loop_trace is not None:
            tracing.record_span(
                "serving.decode.verify", t0, t1, parent=self._loop_trace,
                slots=len(spec), accepted=new_tokens)
        return True

    # -- zero-loss recovery (serving.recovery) -----------------------------

    def _flight_dump(self, reason: str) -> None:
        """Best-effort post-mortem hook: when a FlightRecorder is
        installed, dump a bundle capturing this engine's terminal state
        (span/runlog tails, held locks, page refcounts, the breaker's
        state). Never raises — observability must not alter the failure
        path it is recording."""
        try:
            from paddle_tpu_torch.observability import flight_recorder as fr

            fr.maybe_dump(reason, engine=self)
        except Exception as e:
            ptlog.warning("flight-recorder dump failed: %r", e)

    def _note_step_ok(self) -> None:
        """A clean decode iteration: the device is serving again."""
        if not self._consec_faults and not self._breaker_dirty:
            return
        self._consec_faults = 0
        self._recover_prev_delay = 0.0
        self.metrics.set_consecutive_faults(0)
        self._breaker_dirty = False
        if self._breaker.record_success():
            runlog.emit("engine_recovered", engine=self.metrics.engine_label)

    def _probe_group(self) -> None:
        """Group-backed engines only: per-member canary at
        ``group_probe_every_s`` cadence. ANY member fault is fatal for the
        WHOLE group — the step spans every member, so one sick member
        poisons every shard's sums: trip the breaker and eject (migrate via
        the fleet when attached, else quarantine through the resume path).
        Healthy probes feed the shard-skew straggler watch, which localizes
        a slow member by shard index."""
        if self._group is None:
            return
        now = time.monotonic()
        if now - self._last_probe < self.decode_config.group_probe_every_s:
            return
        self._last_probe = now
        try:
            times = probe_members(self._group, engine_label=self.metrics.engine_label)
        except Exception as e:
            self.metrics.record_member_fault()
            self._breaker_dirty = True
            runlog.emit("group_member_fault", engine=self.metrics.engine_label,
                        group=self._group.name, error=repr(e),
                        in_flight=len(self._active))
            ptlog.error("group %s member fault (%r): ejecting whole group",
                        self._group.name, e)
            if self._rescue_sink is not None:
                self._migrate_out(e)
            else:
                self._breaker.trip()
                self._quarantine(e)
            return
        skew, flagged = self._straggler.observe(times)
        self.metrics.set_shard_skew(skew)
        for shard, secs in times.items():
            self.metrics.set_shard_probe_seconds(shard, secs)
        if flagged is not None:
            self.metrics.record_shard_straggler()
            runlog.emit("group_shard_straggler", engine=self.metrics.engine_label,
                        group=self._group.name, shard=flagged, skew=round(skew, 3))

    def _recover_step_fault(self, exc: BaseException) -> None:
        """A decode step failed: every live request is reconstructible from
        host state, whatever the step left in the pages. Ladder: quarantine
        + re-admit (per-request budget) → after ``unhealthy_after``
        consecutive faults, migrate everything to a healthy engine via the
        fleet's rescue sink. A fault inside recovery itself
        (DECODE_RECOVER) escalates one rung."""
        dconf = self.decode_config
        self.metrics.record_step_fault()
        self._consec_faults += 1
        self.metrics.set_consecutive_faults(self._consec_faults)
        self._breaker_dirty = True
        tripped = self._breaker.record_failure()
        if tripped:
            self._flight_dump("engine_fault")
        runlog.emit("decode_step_error", error=repr(exc), recovering=True,
                    consecutive=self._consec_faults, tripped=tripped,
                    engine=self.metrics.engine_label)
        ptlog.warning(
            "decode step failed (%r); recovering %d request(s) "
            "(consecutive fault %d)", exc, len(self._active),
            self._consec_faults)
        try:
            faults.inject(faults.DECODE_RECOVER, engine=self.metrics.engine_label)
            if (self._consec_faults >= dconf.unhealthy_after
                    and self._rescue_sink is not None):
                self._migrate_out(exc)
                return
            self._quarantine(exc)
        except Exception as rexc:
            # recovery itself faulted: escalate straight to migration
            # when a fleet can take the work, else fail everything (never
            # hang the handles)
            ptlog.error("decode recovery failed: %r", rexc)
            if self._rescue_sink is not None:
                self._migrate_out(rexc)
            else:
                for req in list(self._active):
                    self._fail(req, rexc)
                self._kv.release_all()
            return
        # spread repeated quarantine cycles out
        d = retry_mod.decorrelated_backoff(
            self._recover_prev_delay, dconf.recovery_base_delay_s,
            dconf.recovery_max_delay_s)
        self._recover_prev_delay = d
        time.sleep(d)

    def _retry_budget_spent(self, req: _DecodeRequest, exc: BaseException) -> bool:
        """Count one more quarantine cycle against ``req``; past its
        lifetime budget, fail it with RetriesExhausted."""
        req.recoveries += 1
        if req.recoveries <= self.decode_config.recovery_retries:
            return False
        self.metrics.record_retries_exhausted()
        err = RetriesExhausted(
            f"request {req.rid}: recovery budget "
            f"({self.decode_config.recovery_retries}) exhausted "
            f"(last fault: {exc!r})", request_id=req.rid)
        err.__cause__ = exc
        self._fail(req, err)
        return True

    def _quarantine(self, exc: BaseException) -> None:
        """Release every slot (the poisoned iteration's KV writes are
        untrusted) and send live requests back through the resume path —
        token-exact, per the preemption contract."""
        requeued = 0
        for req in list(self._active):
            self._release(req)
            if self._retry_budget_spent(req, exc):
                continue
            self._requeue(req)
            requeued += 1
            runlog.emit("request_recovered", rid=req.rid,
                        recoveries=req.recoveries, generated=len(req.generated),
                        engine=self.metrics.engine_label,
                        trace_id=req.trace.trace_id if req.trace else None)
        self._kv.release_all()  # nothing survives the poisoned iteration
        if requeued:
            self.metrics.record_recover(requeued)

    def _recover_request(self, req: _DecodeRequest, exc: BaseException) -> None:
        """A prefill chunk failed for ONE request (garbage confined to
        its slot's pages): quarantine just that request through the
        resume path, on the same lifetime budget. Does not count toward
        engine-level consecutive faults."""
        if not self.decode_config.recovery:
            self._fail(req, exc)
            return
        self.metrics.record_step_fault()
        self._release(req)
        if self._retry_budget_spent(req, exc):
            return
        self._requeue(req)
        self.metrics.record_recover(1)
        runlog.emit("request_recovered", rid=req.rid,
                    recoveries=req.recoveries, generated=len(req.generated),
                    engine=self.metrics.engine_label,
                    trace_id=req.trace.trace_id if req.trace else None)

    def _drain_packets(self) -> List[RescuePacket]:
        """Drain every live request's host state (active slots, parked
        queues, and the scheduler backlog) into RescuePackets. Slots are
        released and each rid closes in the journal with "migrated" so a
        replay of THIS engine's journal won't resurrect them — the
        adopting engine journals them afresh."""
        drained: List[_DecodeRequest] = []
        for req in list(self._active):
            self._release(req)
            drained.append(req)
        while self._resume:
            drained.append(self._resume.popleft())
        while self._pending_admit:
            drained.append(self._pending_admit.popleft())
        while self._pending_handoff:
            drained.append(self._pending_handoff.popleft()[0])
        drained += self._drain_queue()
        self._kv.release_all()
        packets: List[RescuePacket] = []
        for req in drained:
            self._j_fin(req, "migrated")
            packets.append(RescuePacket(
                rid=req.rid or "", prompt=req.prompt, mnt=req.mnt,
                generated=list(req.generated), tenant=req.tenant,
                cls=req.cls, deadline=req.deadline, t_submit=req.t_submit,
                n_preemptions=req.n_preemptions, handle=req.handle,
                trace=req.trace, cancelled=req.cancelled))
        return packets

    def _migrate_out(self, exc: BaseException) -> None:
        """Declare this engine unhealthy: trip the breaker (the fleet
        stops routing here until a half-open probe succeeds) and hand
        every live request to the rescue sink for adoption elsewhere."""
        self._breaker.trip()
        self._breaker_dirty = True
        self._flight_dump("breaker_trip")
        packets = self._drain_packets()
        runlog.emit("engine_unhealthy", engine=self.metrics.engine_label,
                    error=repr(exc), in_flight=len(packets),
                    consecutive=self._consec_faults)
        ptlog.error(
            "engine %s unhealthy after %d consecutive step faults; "
            "migrating %d request(s)", self.metrics.engine_label,
            self._consec_faults, len(packets))
        adopted = self._rescue_sink(self, packets) if packets else 0
        self.metrics.record_migrate(adopted)
        self._consec_faults = 0
        self._recover_prev_delay = 0.0
        self.metrics.set_consecutive_faults(0)

    def adopt_rescue(self, packet: RescuePacket,
                     from_engine: Optional[str] = None) -> DecodeHandle:
        """Adopt a request drained from another engine: generation
        continues token-exactly from its ``prompt + generated`` host state
        through the resume path. The client's original handle — when the
        packet carries one — is repointed here, so ``result()``/
        ``cancel()`` keep working. Returns the (possibly fresh) handle."""
        if self._closed:
            raise EngineClosedError("engine is closed")
        prompt = np.asarray(packet.prompt, np.int32).reshape(-1)
        req = _DecodeRequest(
            prompt, int(packet.mnt),
            self._n_chunks(int(prompt.size) + len(packet.generated)),
            packet.deadline, packet.t_submit or time.monotonic(),
            tenant=packet.tenant, cls=packet.cls)
        req.generated = [int(t) for t in packet.generated]
        req.n_preemptions = packet.n_preemptions
        req.cancelled = packet.cancelled
        req.rid = packet.rid or self._new_rid()
        if packet.handle is not None:
            req.handle = packet.handle
            packet.handle._req = req  # cancel() must target the new req
        t0_rescue = time.perf_counter()
        req.trace = packet.trace
        if req.trace is None and tracing.tracing_enabled():
            req.trace = tracing.SpanContext.new_trace()
        if req.trace is not None:
            req.handle.trace = req.trace
            req.t_enqueue_pc = time.perf_counter()
        # already satisfied (e.g. a crash landed between the last token and
        # its fin record): complete without re-decoding a single token
        if self._complete_if_satisfied(req):
            return req.handle
        self._j_admit(req)
        self.metrics.record_submit()
        if req.trace is not None:
            tracing.record_span(
                "serving.rescue", t0_rescue, time.perf_counter(),
                parent=req.trace, engine=self.metrics.engine_label,
                from_engine=from_engine, rid=req.rid,
                generated=len(req.generated))
        if from_engine is not None:
            runlog.emit("request_migrated", rid=req.rid, from_engine=from_engine,
                        to_engine=self.metrics.engine_label,
                        generated=len(req.generated),
                        trace_id=req.trace.trace_id if req.trace else None)
        # front-of-line with the resumed: the request already waited once
        self._resume.append(req)
        self._queue.poke()  # an idle loop is parked in recv(idle_poll_s)
        return req.handle

    def _complete_if_satisfied(self, req: _DecodeRequest) -> bool:
        """An adopted request whose generated prefix already ends it (eos,
        or its budget): journal and complete it without a single step."""
        eos = self.decode_config.eos_id
        done_eos = bool(eos is not None and req.generated and req.generated[-1] == eos)
        if not done_eos and len(req.generated) < req.mnt:
            return False
        reason = "eos" if done_eos else "length"
        self._j_admit(req)
        self._j_fin(req, reason)
        req.handle._complete(DecodeOutput(
            tokens=np.asarray(req.generated, dtype=np.int32),
            finish_reason=reason, prompt_len=int(req.prompt.size),
            n_preemptions=req.n_preemptions))
        return True

    # -- disaggregated prefill/decode handoff (serving.disagg) -------------

    def _publish_handoff(self, req: _DecodeRequest) -> None:
        """Prefill-role exit: prefill just completed, so the slot's pages
        hold the request's full context — gather them (on the card, one
        ``index_select`` per page array, an event recorded after it),
        release the slot, and hand the payload to the router's sink.
        Durability (journal handoff record + receiver ack) is the router's
        job; a sink failure degrades to decoding locally through the
        resume path, so a broken transfer never loses the request."""
        from paddle_tpu_torch.serving.disagg import HandoffPayload

        dconf = self.decode_config
        n_pages = -(-req.cur_len // dconf.page_size)
        # gather BEFORE _release: the freed pages' next writes are queued
        # behind the gather on this stream
        k_pages, v_pages = self._gather_pages(self._kv.slot_pages(req.slot)[:n_pages])
        ready = None
        if self._device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
        payload = HandoffPayload(
            rid=req.rid or "", prompt=req.prompt,
            generated=list(req.generated), mnt=req.mnt,
            tenant=req.tenant, cls=req.cls, deadline=req.deadline,
            t_submit=req.t_submit, n_preemptions=req.n_preemptions,
            cur_len=int(req.cur_len), last_tok=int(req.last_tok),
            page_size=dconf.page_size, k_pages=k_pages, v_pages=v_pages,
            src=self.metrics.engine_label, handle=req.handle,
            trace=req.trace, tp_degree=self.tp_degree, ready=ready)
        self._release(req)
        try:
            self._handoff_sink(self, payload)
        except Exception as e:
            ptlog.warning("KV handoff failed (%r); request %s continues "
                          "decoding locally", e, req.rid)
            self._requeue(req)
            return
        self.metrics.record_handoff_out()
        # with a per-engine WAL, close the rid here — the adopting engine
        # journals it afresh, so a replay of THIS file cannot resurrect a
        # request that now lives elsewhere. With a journal SHARED across
        # the fleet the rid must stay open (the adopter keeps appending
        # under it); the handoff/ack records carry the transfer state.
        if self._journal_owned:
            self._j_fin(req, "migrated")
        runlog.emit("handoff_published", rid=req.rid, pages=n_pages,
                    engine=self.metrics.engine_label)

    def adopt_handoff(self, payload,
                      from_engine: Optional[str] = None) -> DecodeHandle:
        """Adopt a prefilled request handed off by a prefill-role engine
        (:class:`~paddle_tpu_torch.serving.disagg.HandoffPayload`): its KV
        pages are implanted on the loop thread and decode continues from
        ``cur_len`` without re-prefilling. The client's original handle
        is repointed here, mirroring :meth:`adopt_rescue`. Thread-safe;
        returns the (possibly fresh) handle."""
        if self._closed:
            raise EngineClosedError("engine is closed")
        prompt = np.asarray(payload.prompt, np.int32).reshape(-1)
        req = _DecodeRequest(
            prompt, int(payload.mnt),
            self._n_chunks(int(prompt.size) + len(payload.generated)),
            payload.deadline, payload.t_submit or time.monotonic(),
            tenant=payload.tenant, cls=payload.cls)
        req.generated = [int(t) for t in payload.generated]
        req.n_preemptions = payload.n_preemptions
        req.rid = payload.rid or self._new_rid()
        if payload.handle is not None:
            req.handle = payload.handle
            payload.handle._req = req  # cancel() must target the new req
        req.trace = payload.trace
        if req.trace is None and tracing.tracing_enabled():
            req.trace = tracing.SpanContext.new_trace()
        if req.trace is not None:
            req.handle.trace = req.trace
            req.t_enqueue_pc = time.perf_counter()
        # the prefill worker's final-chunk sample may already satisfy the
        # request: complete without decoding (same as adopt_rescue)
        if self._complete_if_satisfied(req):
            return req.handle
        self._j_admit(req)
        self.metrics.record_submit()
        if from_engine is not None:
            runlog.emit(
                "request_handed_off", rid=req.rid, from_engine=from_engine,
                to_engine=self.metrics.engine_label,
                generated=len(req.generated),
                trace_id=req.trace.trace_id if req.trace else None)
        self._pending_handoff.append((req, payload))
        self._queue.poke()  # an idle loop is parked in recv(idle_poll_s)
        return req.handle

    def _drain_queue(self) -> List[_DecodeRequest]:
        """Every request still in the scheduler, popped without waiting."""
        out: List[_DecodeRequest] = []
        while True:
            try:
                req, ok = self._queue.recv(timeout=0)
            except Exception:
                break
            if not ok:
                break
            out.append(req)
        return out

    def kill(self) -> None:
        """Simulate abrupt engine death (chaos/testing): no drain, no
        journal fin records — exactly the state a crashed process leaves
        behind. In-flight handles fail with :class:`EngineUnhealthy`; the
        journal file still names every incomplete request, which is what
        ``recovery.resume_incomplete()`` rebuilds from."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # the "crash" happens NOW: nothing more reaches the WAL (in
        # particular no fin records for in-flight requests)
        journal, self._journal = self._journal, None
        self._killed = True
        # post-mortem first, while slots/refcounts still show the crash
        # state the bundle exists to explain
        self._flight_dump("kill")
        self._queue.close()
        self._thread.join(5.0)
        if journal is not None and self._journal_owned:
            journal.close()  # release the fd; on-disk bytes stay as-is
        exc = EngineUnhealthy(f"engine {self.metrics.engine_label} killed")
        drained = (list(self._active) + list(self._resume)
                   + list(self._pending_admit)
                   + [item[0] for item in self._pending_handoff])
        self._active.clear()
        self._resume.clear()
        self._pending_admit.clear()
        self._pending_handoff.clear()
        drained += self._drain_queue()
        self._kv.release_all()
        if self._prefix is not None:
            self._prefix.clear()
        # the host tier is deliberately NOT cleared: a shared pool is the
        # crash-recovery substrate — the restarted engine repopulates its
        # radix tree from it
        self._promote_jobs.clear()
        self._promote_keys.clear()
        for req in drained:
            if not req.handle.done():
                req.handle._fail(exc)
        if self._admission is not None:
            admission_mod.uninstall(self._admission)

    # -- shutdown ----------------------------------------------------------

    # grace period for the loop to notice _drain_abort at an iteration
    # boundary once the close() timeout has been overrun
    _DRAIN_ABORT_GRACE_S = 5.0

    def _force_drain(self) -> None:
        """The close() drain deadline passed: complete every in-flight
        request with the tokens it has (``finish_reason="drain_timeout"``)
        instead of leaving its handle hanging forever, then prove no KV
        page leaked."""
        drained = (list(self._active) + list(self._resume)
                   + list(self._pending_admit)
                   + [item[0] for item in self._pending_handoff])
        self._resume.clear()
        self._pending_admit.clear()
        self._pending_handoff.clear()
        drained += self._drain_queue()
        for req in drained:
            self._finish(req, "drain_timeout")
        if self._prefix is not None:
            self._prefix.clear()
        self._kv.assert_no_leaks()

    def close(self, timeout: Optional[float] = None) -> List[str]:
        """Graceful drain: stop intake, run every accepted request to
        completion, then stop the loop. The drain deadline is ENFORCED:
        when ``timeout`` is overrun, the loop force-finishes stragglers
        with ``finish_reason="drain_timeout"`` (partial tokens returned,
        no handle left waiting forever) and the page-leak check still
        runs. Returns unjoined thread names (empty = clean)."""
        with self._close_lock:
            if self._closed:
                return []
            self._closed = True
        self._queue.close()
        self._thread.join(timeout)
        if timeout is not None and self._thread.is_alive():
            ptlog.error(
                "DecodeEngine.close: drain exceeded %ss; force-finishing "
                "in-flight requests with finish_reason=drain_timeout",
                timeout)
            self._drain_abort = True
            self._thread.join(self._DRAIN_ABORT_GRACE_S)
        unjoined = [self._thread.name] if self._thread.is_alive() else []
        if unjoined:
            ptlog.error("DecodeEngine.close: loop failed to join within %s",
                        timeout)
        if self._journal is not None and self._journal_owned:
            self._journal.close()
        if self._admission is not None:
            admission_mod.uninstall(self._admission)
        return unjoined

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self.close()
        return False
