"""Disaggregated prefill/decode serving: role-split worker fleets with
durable KV-page handoff and SLO-driven elastic rebalancing — port of
``paddle_tpu.serving.disagg``.

Chunked prefill and decode inside one engine share its loop: a
compute-bound prefill storm steals iterations from latency-bound decode.
This module puts the two phases on separate workers — the reference
framework's trainer/pserver role split, made elastic:

- **Prefill workers** run ``paged_prefill_chunk`` to completion, then
  publish the request's KV pages instead of decoding
  (``DecodeEngine._publish_handoff``).
- **Decode workers** adopt published pages straight into their decode
  loop (``DecodeEngine.adopt_handoff``) and continue from ``cur_len``
  without re-prefilling.
- The :class:`DisaggRouter` (a :class:`DecodeFleet`) connects them. On
  the ``"device"`` transport the pages never leave the card: the prefill
  worker gathers them with one ``index_select`` from its page arrays and
  the decode worker implants them with one ``index_copy_``, ordered by a
  CUDA event recorded after the gather. On the ``"serialized"``
  transport they travel as a :class:`HandoffPayload` wire blob with a CRC
  per page — the JAX package's format byte for byte, bf16 pages included
  — and a receiver rejects torn transfers (:class:`HandoffCorrupt`)
  instead of adopting garbage KV state.

**Durability.** The handoff window is journaled like everything else: a
``hof`` record (full request snapshot, fsync'd BEFORE the transfer) in
the shared :class:`~paddle_tpu_torch.serving.recovery.RequestJournal`,
and an ``ack`` record once the receiver adopted the pages. A prefill
worker dying mid-transfer leaves ``hof`` without ``ack`` — replay
resumes the request by re-prefilling on a surviving worker, token-exact.
A torn or corrupt payload degrades the same way at adoption time.

**Elasticity.** An :class:`Autoscaler` consumes the ``watch`` SLO burn
rate of interactive decode p99 plus queue-depth anomaly signals and
**drain-and-converts** workers between roles at safe boundaries —
graceful drain (``DecodeEngine.close``), role flip, a factory-built
replacement.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import tracing
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import enforce, enforce_in
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.host_tier import page_blob, page_from_blob
from paddle_tpu_torch.serving.recovery import (
    DecodeFleet,
    EngineUnhealthy,
    RequestJournal,
    RescuePacket,
)

__all__ = [
    "PREFILL",
    "DECODE",
    "HandoffCorrupt",
    "HandoffPayload",
    "DisaggRouter",
    "Autoscaler",
    "AutoscalerConfig",
]

PREFILL = "prefill"
DECODE = "decode"
_ROLES = (PREFILL, DECODE)

# wire format version tag for serialized handoffs
_MAGIC = b"PTKV1\n"
_HDR = struct.Struct("<II")  # header length, header crc32


class HandoffCorrupt(RuntimeError):
    """A serialized handoff payload failed validation (truncated buffer,
    header or page CRC mismatch). The receiver must NOT adopt any of it —
    the request re-prefills from its journaled host state instead."""


def _trace_from_header(header: Optional[str]):
    """Wire traceparent -> SpanContext. Version-tolerant on both axes:
    an absent key (old writer) and a malformed value both decode to None
    — trace context is advisory and must never fail an otherwise-valid
    handoff."""
    if not header:
        return None
    try:
        return tracing.SpanContext.from_traceparent(header)
    except Exception:
        return None


def _host_pages(pages: List[torch.Tensor]) -> List[torch.Tensor]:
    """The pages in host memory, brought over in ONE copy (the wire image
    needs them there)."""
    return list(torch.stack([p.detach() for p in pages]).cpu()) if pages else []


@dataclasses.dataclass
class HandoffPayload:
    """One prefilled request in transit between workers: host-side
    request state (the :class:`RescuePacket` fields) plus the KV pages
    the prefill worker produced. ``cur_len`` positions are covered by the
    pages; ``last_tok`` (= ``generated[-1]``) is the token whose KV write
    is still pending — exactly the mid-decode state the adopting engine's
    step loop expects. ``handle`` is process-local and never serialized;
    :meth:`from_bytes` leaves it None for the caller to re-attach.
    ``trace`` (a :class:`~paddle_tpu_torch.tracing.SpanContext`) DOES ride the
    wire — as a W3C traceparent string inside the CRC'd header — so the
    adopting worker's spans parent under the original request trace
    across processes. Decode is version-tolerant: a payload without the
    key (an older writer) adopts with ``trace=None``.

    ``k_pages``/``v_pages`` hold one ``[L, H_kv, page_size, dh]`` tensor
    per logical page: a list, or one ``[n, L, H_kv, page_size, dh]``
    tensor. On the ``"device"`` transport they stay on the card as the
    prefill worker gathered them (one tensor), and ``ready`` is the CUDA
    event recorded on its stream right after the gather — process-local
    like ``handle``; the adopter's stream waits on it before the implant.
    :meth:`from_bytes` returns lists of CPU tensors."""

    rid: str
    prompt: np.ndarray
    generated: List[int]
    mnt: int
    cur_len: int
    last_tok: int
    page_size: int
    k_pages: List[Any]
    v_pages: List[Any]
    tenant: str = "default"
    cls: str = "interactive"
    deadline: Optional[float] = None
    t_submit: float = 0.0
    n_preemptions: int = 0
    src: str = ""
    handle: Optional[Any] = None
    trace: Optional[Any] = None
    # tp degree of the group that GATHERED the pages (1 = single device).
    # Pages on the wire are always full logical pages, but an adopter
    # with a different degree ran a different partitioned program, so it
    # rejects the pages and re-prefills (serving.decode._admit_handoffs)
    tp_degree: int = 1
    ready: Optional[Any] = None

    def to_bytes(self) -> bytes:
        """Serialize for cross-process transfer: a CRC-protected JSON
        header (request state + page geometry + one CRC per page blob)
        followed by the raw page bytes. Same self-validating discipline
        as the journal's records — corruption is detected, never
        adopted."""
        pages = [page_blob(p) for p in _host_pages(list(self.k_pages) + list(self.v_pages))]
        blobs = [b for b, _, _ in pages]
        shape = list(pages[0][1]) if pages else []
        dtype = pages[0][2] if pages else "float32"
        header = {
            "rid": self.rid,
            "prompt": [int(t) for t in
                       np.asarray(self.prompt).reshape(-1)],
            "generated": [int(t) for t in self.generated],
            "mnt": int(self.mnt),
            "cur_len": int(self.cur_len),
            "last_tok": int(self.last_tok),
            "page_size": int(self.page_size),
            "tenant": self.tenant,
            "cls": self.cls,
            "deadline": self.deadline,
            "t_submit": float(self.t_submit),
            "n_preemptions": int(self.n_preemptions),
            "src": self.src,
            "tp_degree": int(self.tp_degree),
            "trace": (self.trace.to_traceparent()
                      if self.trace is not None else None),
            "n_pages": len(self.k_pages),
            "shape": shape,
            "dtype": dtype,
            "page_crcs": [zlib.crc32(b) & 0xFFFFFFFF for b in blobs],
        }
        hjson = json.dumps(header, separators=(",", ":"),
                           sort_keys=True).encode("utf-8")
        parts = [_MAGIC,
                 _HDR.pack(len(hjson), zlib.crc32(hjson) & 0xFFFFFFFF),
                 hjson]
        parts.extend(blobs)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "HandoffPayload":
        """Parse + validate a wire blob. Raises :class:`HandoffCorrupt`
        on any inconsistency — a torn transfer must be rejected whole,
        not partially adopted."""
        if not data.startswith(_MAGIC):
            raise HandoffCorrupt("bad magic: not a handoff payload")
        off = len(_MAGIC)
        if len(data) < off + _HDR.size:
            raise HandoffCorrupt("truncated header prefix")
        hlen, hcrc = _HDR.unpack_from(data, off)
        off += _HDR.size
        hjson = data[off:off + hlen]
        if len(hjson) != hlen:
            raise HandoffCorrupt("truncated header")
        if (zlib.crc32(hjson) & 0xFFFFFFFF) != hcrc:
            raise HandoffCorrupt("header CRC mismatch")
        off += hlen
        try:
            h = json.loads(hjson.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise HandoffCorrupt(f"header undecodable: {e}") from None
        n_pages = int(h["n_pages"])
        shape = tuple(int(d) for d in h["shape"])
        try:
            itemsize = torch.empty((), dtype=dtypes.convert(h["dtype"])).element_size()
        except (KeyError, TypeError) as e:
            raise HandoffCorrupt(f"unknown page dtype: {e}") from None
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        crcs = h["page_crcs"]
        if len(crcs) != 2 * n_pages:
            raise HandoffCorrupt("page CRC count mismatch")
        if len(data) - off != 2 * n_pages * nbytes:
            raise HandoffCorrupt(
                f"torn transfer: expected {2 * n_pages * nbytes} page "
                f"bytes, got {len(data) - off}")
        pages: List[torch.Tensor] = []
        for i in range(2 * n_pages):
            blob = data[off + i * nbytes:off + (i + 1) * nbytes]
            if (zlib.crc32(blob) & 0xFFFFFFFF) != int(crcs[i]):
                raise HandoffCorrupt(f"page {i} CRC mismatch")
            pages.append(page_from_blob(blob, shape, h["dtype"]))
        return cls(
            rid=h["rid"],
            prompt=np.asarray(h["prompt"], np.int32),
            generated=[int(t) for t in h["generated"]],
            mnt=int(h["mnt"]), cur_len=int(h["cur_len"]),
            last_tok=int(h["last_tok"]), page_size=int(h["page_size"]),
            k_pages=pages[:n_pages], v_pages=pages[n_pages:],
            tenant=h.get("tenant", "default"),
            cls=h.get("cls", "interactive"),
            deadline=h.get("deadline"),
            t_submit=float(h.get("t_submit", 0.0)),
            n_preemptions=int(h.get("n_preemptions", 0)),
            src=h.get("src", ""),
            tp_degree=int(h.get("tp_degree", 1)),
            trace=_trace_from_header(h.get("trace")),
        )

    def to_rescue_packet(self) -> RescuePacket:
        """The re-prefill fallback: everything but the pages, in the
        shape :meth:`DecodeEngine.adopt_rescue` already speaks."""
        return RescuePacket(
            rid=self.rid, prompt=self.prompt, mnt=self.mnt,
            generated=list(self.generated), tenant=self.tenant,
            cls=self.cls, deadline=self.deadline, t_submit=self.t_submit,
            n_preemptions=self.n_preemptions, handle=self.handle,
            trace=self.trace)


class DisaggRouter(DecodeFleet):
    """A :class:`DecodeFleet` whose engines play roles. ``submit`` routes
    new requests to prefill-role workers (least-loaded, breaker-aware —
    the inherited ``_pick`` over a role-filtered candidate set); when a
    prefill worker finishes a request's prefill it publishes the KV
    pages through :meth:`_handoff`, which journals the transfer, moves
    the pages (device or serialized transport), and hands the request to
    a decode-role worker.

    Failure ladder at the handoff boundary, worst to best outcome still
    being a completed request:

    1. transfer + adoption succeed → decode continues on the adopted
       pages (no re-prefill; ``ack`` journaled);
    2. transfer torn/corrupt or adoption fails → the request re-prefills
       on a decode worker via the rescue path (token-exact);
    3. no healthy decode worker → the publishing engine keeps the
       request and decodes it locally (degraded but zero-loss);
    4. the prefill worker dies mid-transfer → the journal's unacked
       ``hof`` record resumes it on a surviving worker
       (``resume_incomplete``).

    ``journal`` (or ``journal_path``) installs one WAL SHARED by the
    router and every journal-less engine, so a single replay file covers
    the whole fleet including the handoff window. ``factory(role)``
    builds replacement engines for :meth:`convert` (each warms up at
    construction with ``DecodeConfig(warmup=True)``; the JAX package's
    warm-up manifest, ``prewarm=True``, is not ported: ``ROADMAP.md`` §A
    item 7)."""

    def __init__(
        self,
        engines: List[Any],
        roles: List[str],
        *,
        transport: str = "device",
        journal: Optional[RequestJournal] = None,
        journal_path: Optional[str] = None,
        factory: Optional[Callable[[str], Any]] = None,
        convert_drain_timeout_s: float = 10.0,
    ):
        super().__init__(engines)
        enforce(len(roles) == len(engines),
                f"{len(engines)} engines but {len(roles)} roles")
        for r in roles:
            enforce_in(r, _ROLES, "worker role")
        enforce(DECODE in roles,
                "DisaggRouter needs at least one decode-role worker")
        enforce_in(transport, ("device", "serialized"), "handoff transport")
        self.transport = transport
        self.factory = factory
        self.convert_drain_timeout_s = float(convert_drain_timeout_s)
        self._roles: Dict[int, str] = {
            id(e): r for e, r in zip(self.engines, roles)}
        self._journal = journal
        self._journal_owned = False
        if journal is None and journal_path:
            self._journal = RequestJournal(journal_path)
            self._journal_owned = True
        self.handoffs_total = 0
        self.handoff_rejects_total = 0
        self.handoff_reprefills_total = 0
        self.conversions_total = 0
        for eng in self.engines:
            self._wire(eng, self._roles[id(eng)])

    def _wire(self, eng, role: str) -> None:
        """Attach one engine to the router's plumbing for its role."""
        eng._rescue_sink = self._rescue
        if self._journal is not None and eng._journal is None:
            eng._journal = self._journal
            eng._journal_owned = False
        eng._handoff_sink = self._handoff if role == PREFILL else None

    # -- role bookkeeping --------------------------------------------------

    def role(self, eng) -> str:
        return self._roles.get(id(eng), DECODE)

    def workers(self, role: str) -> List[Any]:
        return [e for e in self.engines if self._roles.get(id(e)) == role]

    @property
    def n_prefill(self) -> int:
        return sum(1 for e in self.workers(PREFILL) if not e.closed)

    @property
    def n_decode(self) -> int:
        return sum(1 for e in self.workers(DECODE) if not e.closed)

    def queue_depths(self) -> Dict[str, float]:
        """Live work per role (the Autoscaler's queue-depth signal)."""
        return {
            role: float(sum(e.load() for e in self.workers(role)
                            if not e.closed))
            for role in _ROLES
        }

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kwargs):
        """Route to the healthy prefill-role worker with the longest
        cached prefix of ``prompt`` (least-loaded tiebreak — see
        ``DecodeFleet._pick``); with none available (all converted away,
        breakers open), any healthy worker takes the request end-to-end —
        degraded, never down."""
        eng = self._pick(candidates=self.workers(PREFILL), prompt=prompt)
        if eng is None:
            eng = self._pick(prompt=prompt)
        if eng is None:
            raise EngineUnhealthy(
                "no healthy worker (all breakers open or draining)")
        return eng.submit(prompt, max_new_tokens, **kwargs)

    # -- the handoff path (runs on the prefill worker's loop thread) -------

    def _handoff(self, src, payload: HandoffPayload) -> None:
        """Move one prefilled request from ``src`` to a decode worker.
        Raises when nothing could take it — the publisher then resumes
        the request locally (rung 3 of the ladder)."""
        if self._journal is not None:
            # durable intent BEFORE the transfer: a crash from here on
            # leaves an unacked hof record that replay re-prefills from
            self._journal.log_handoff(
                payload.rid, payload.prompt, payload.mnt,
                payload.generated, payload.tenant, payload.cls,
                src=src.metrics.engine_label, dst=None,
                trace=(payload.trace.to_traceparent()
                       if payload.trace is not None else None))
        dst = self._pick(exclude=src, candidates=self.workers(DECODE))
        if dst is None:
            raise EngineUnhealthy(
                f"request {payload.rid}: no healthy decode-role worker "
                f"to adopt the handoff")
        t0_transfer = time.perf_counter()
        try:
            faults.inject(faults.DISAGG_HANDOFF, rid=payload.rid,
                          src=src.metrics.engine_label,
                          dst=dst.metrics.engine_label)
            if self.transport == "serialized":
                recv = HandoffPayload.from_bytes(payload.to_bytes())
                # the handle is process-local, never on the wire; the
                # trace context round-trips inside the CRC'd header
                recv.handle = payload.handle
                payload = recv
            dst.adopt_handoff(payload,
                              from_engine=src.metrics.engine_label)
        except Exception as e:
            # rung 2: reject the pages (torn transfer, corrupt payload,
            # dst refused) and re-prefill on a decode worker instead —
            # token-exact from prompt + generated, the rescue contract
            self.handoff_rejects_total += 1
            prof.inc_counter("serving.disagg.handoff_rejects")
            runlog.emit("handoff_rejected", rid=payload.rid,
                        error=repr(e), src=src.metrics.engine_label)
            ptlog.warning("handoff of %s rejected (%r); re-prefilling",
                          payload.rid, e)
            dst2 = self._pick(exclude=src, candidates=self.workers(DECODE))
            if dst2 is None:
                raise EngineUnhealthy(
                    f"request {payload.rid}: handoff rejected and no "
                    f"decode-role worker left to re-prefill on") from e
            dst2.adopt_rescue(payload.to_rescue_packet(),
                              from_engine=src.metrics.engine_label)
            self.handoff_reprefills_total += 1
            return
        if self._journal is not None:
            try:
                self._journal.log_handoff_ack(
                    payload.rid, dst.metrics.engine_label)
            except Exception as e:
                # adoption already happened; an unacked hof at worst
                # re-resumes an already-running request on replay
                ptlog.warning("handoff ack journaling failed: %r", e)
        self.handoffs_total += 1
        prof.inc_counter("serving.disagg.handoffs")
        if payload.trace is not None:
            tracing.record_span(
                "serving.handoff.transfer", t0_transfer,
                time.perf_counter(), parent=payload.trace,
                engine=src.metrics.engine_label,
                dst=dst.metrics.engine_label, rid=payload.rid,
                transport=self.transport)

    # -- drain-and-convert -------------------------------------------------

    def convert(self, engine, to_role: str,
                timeout: Optional[float] = None):
        """Drain-and-convert one worker to the other role at a safe
        boundary: exclude it from routing, gracefully drain it
        (``close`` runs every accepted request to completion — or, past
        the deadline, completes them with partial tokens rather than
        hanging), then swap in a factory-built replacement wearing the
        new role. ``engine`` is an engine object or its label. Returns the
        replacement engine."""
        enforce(self.factory is not None,
                "DisaggRouter.convert needs a factory(role) callable")
        enforce_in(to_role, _ROLES, "worker role")
        eng = engine
        if isinstance(engine, str):
            eng = next((e for e in self.engines
                        if e.metrics.engine_label == engine), None)
            enforce(eng is not None, f"no worker labeled {engine!r}")
        from_role = self._roles[id(eng)]
        if from_role == to_role and not eng.closed:
            return eng
        self._draining.add(id(eng))
        try:
            eng.close(timeout if timeout is not None
                      else self.convert_drain_timeout_s)
            new = self.factory(to_role)
            self._wire(new, to_role)
            with self._lock:
                i = self.engines.index(eng)
                self.engines[i] = new
            self._roles.pop(id(eng), None)
            self._roles[id(new)] = to_role
        finally:
            self._draining.discard(id(eng))
        self.conversions_total += 1
        prof.inc_counter("serving.disagg.conversions",
                         labels={"to_role": to_role})
        runlog.emit("worker_converted", engine=eng.metrics.engine_label,
                    from_role=from_role, to_role=to_role,
                    new_engine=new.metrics.engine_label)
        return new

    # -- introspection / shutdown ------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        snap = super().snapshot()
        for entry, eng in zip(snap["engines"], self.engines):
            entry["role"] = self._roles.get(id(eng), DECODE)
            entry["load"] = eng.load()
        snap.update({
            "transport": self.transport,
            "handoffs_total": self.handoffs_total,
            "handoff_rejects_total": self.handoff_rejects_total,
            "handoff_reprefills_total": self.handoff_reprefills_total,
            "conversions_total": self.conversions_total,
        })
        return snap

    def close(self, timeout: Optional[float] = None) -> List[str]:
        unjoined = super().close(timeout)
        if self._journal is not None and self._journal_owned:
            self._journal.close()
        return unjoined


# -- SLO-driven autoscaling ---------------------------------------------------

@dataclasses.dataclass
class AutoscalerConfig:
    """Policy knobs for :class:`Autoscaler`. The decision core
    (:meth:`Autoscaler.decide`) is pure over these — see its docstring
    for the rule table."""

    # the watch SLO whose burn rate stands for "interactive decode p99
    # is suffering" (e.g. one of serving_slos()); None = no SLO feed
    slo_name: Optional[str] = None
    # long-window burn rate above which decode needs capacity NOW
    burn_threshold: float = 1.0
    # prefill backlog (router.queue_depths()["prefill"]) treated as a
    # spike even without a detector flag
    spike_depth: float = 8.0
    # both roles at or below this depth = the fleet is idle
    idle_depth: float = 0.0
    # never convert below these per-role floors
    min_prefill: int = 1
    min_decode: int = 1
    # idle convergence target for the prefill side
    floor_prefill: int = 1
    # minimum seconds between conversions (drain + re-warm are not free)
    cooldown_s: float = 30.0


class Autoscaler:
    """Rebalances a :class:`DisaggRouter`'s prefill:decode ratio from
    measured load — the GDP/placement direction from the paper trail
    applied to serving roles, replacing fluid's hand-assigned
    trainer/pserver split.

    Rules, in priority order (:meth:`decide` is pure and unit-testable;
    :meth:`tick` feeds it live signals and applies the action):

    1. decode SLO burning (burn rate > ``burn_threshold``) and a prefill
       worker to spare → ``scale_decode`` (convert prefill → decode);
    2. prefill backlog spiking (EWMA anomaly or depth >
       ``spike_depth``) while the decode SLO is healthy and a decode
       worker to spare → ``scale_prefill``;
    3. fleet idle → converge the prefill side toward
       ``floor_prefill``.

    Conversions are rate-limited by ``cooldown_s``: a drain-and-convert
    costs a drain plus a replacement's warm-up, so the scaler must not
    thrash on one noisy window."""

    SCALE_DECODE = "scale_decode"
    SCALE_PREFILL = "scale_prefill"

    def __init__(self, router: DisaggRouter,
                 config: Optional[AutoscalerConfig] = None,
                 slo_engine=None, detector=None,
                 clock=time.monotonic):
        self.router = router
        self.config = config or AutoscalerConfig()
        self.slo_engine = slo_engine
        if detector is None:
            from paddle_tpu_torch.watch.detectors import EwmaDetector

            detector = EwmaDetector(alpha=0.2, z_threshold=6.0,
                                    min_samples=16)
        self.detector = detector
        self._clock = clock
        self._last_action_ts = -1e18
        self.actions_total: Dict[str, int] = {}

    def decide(
        self,
        *,
        burn_rate: Optional[float],
        prefill_depth: float,
        decode_depth: float,
        n_prefill: int,
        n_decode: int,
        queue_spike: bool = False,
    ) -> Optional[str]:
        """The pure decision core: signals in, action (or None) out.
        Never consults clocks, the router, or the SLO engine — tests
        drive every branch directly."""
        cfg = self.config
        burning = (burn_rate is not None
                   and burn_rate > cfg.burn_threshold)
        if burning and n_prefill > cfg.min_prefill:
            return self.SCALE_DECODE
        spike = queue_spike or prefill_depth > cfg.spike_depth
        if spike and not burning and n_decode > cfg.min_decode:
            return self.SCALE_PREFILL
        idle = (not burning and prefill_depth <= cfg.idle_depth
                and decode_depth <= cfg.idle_depth)
        if idle:
            if (n_prefill > cfg.floor_prefill
                    and n_prefill > cfg.min_prefill):
                return self.SCALE_DECODE
            if (n_prefill < cfg.floor_prefill
                    and n_decode > cfg.min_decode):
                return self.SCALE_PREFILL
        return None

    def _burn_rate(self) -> Optional[float]:
        if self.slo_engine is None or not self.config.slo_name:
            return None
        for st in self.slo_engine.status():
            if st.get("name") == self.config.slo_name:
                return st.get("burn_rate")
        return None

    def tick(self) -> Optional[str]:
        """Read live signals, decide, and apply (convert one worker).
        Returns the action taken, or None (healthy / cooling down / no
        donor)."""
        now = self._clock()
        if now - self._last_action_ts < self.config.cooldown_s:
            return None
        depths = self.router.queue_depths()
        pd, dd = depths[PREFILL], depths[DECODE]
        res = self.detector.observe("disagg.prefill_depth", pd)
        action = self.decide(
            burn_rate=self._burn_rate(), prefill_depth=pd,
            decode_depth=dd, n_prefill=self.router.n_prefill,
            n_decode=self.router.n_decode,
            queue_spike=bool(res is not None and res.flagged))
        if action is None:
            return None
        donor_role = (PREFILL if action == self.SCALE_DECODE else DECODE)
        to_role = DECODE if donor_role == PREFILL else PREFILL
        donors = [e for e in self.router.workers(donor_role)
                  if not e.closed]
        if not donors:
            return None
        donor = min(donors, key=lambda e: e.load())
        try:
            self.router.convert(donor, to_role)
        except Exception as e:
            ptlog.warning("autoscale %s failed: %r", action, e)
            return None
        self._last_action_ts = now
        self.actions_total[action] = self.actions_total.get(action, 0) + 1
        prof.inc_counter("serving.disagg.autoscale_actions",
                         labels={"action": action})
        runlog.emit("autoscale", action=action,
                    donor=donor.metrics.engine_label,
                    prefill_depth=pd, decode_depth=dd,
                    n_prefill=self.router.n_prefill,
                    n_decode=self.router.n_decode)
        return action
