"""Zero-loss decode: request recovery, the durable journal, engine
migration — port of ``paddle_tpu.serving.recovery``.

Three nested safety rings, as in the JAX package:

1. **Step-fault recovery** (innermost, in ``serving.decode``): a failed
   decode iteration quarantines the batch — every slot released, every
   live request re-admitted through the preempt/resume path — under a
   per-request retry budget with decorrelated-jitter backoff.
   Deterministic poison surfaces a typed :class:`RetriesExhausted`.
2. **Cross-engine migration**: ``unhealthy_after`` consecutive faulted
   iterations trip the engine's ``CircuitBreaker``; its live requests
   drain into host-side :class:`RescuePacket`\\ s and a
   :class:`DecodeFleet` resubmits them on a healthy engine, where greedy
   decode continues token-exactly. Half-open probing re-admits the engine
   after cooldown.
3. **Durable journal** (outermost, survives the process): an append-only
   :class:`RequestJournal` — CRC per record, torn-tail tolerant, batched
   fsync off the step path — records admission and every generated token.
   :func:`replay_journal` reconstructs state after a restart;
   :func:`resume_incomplete` resubmits unfinished requests. The record
   format is the JAX package's byte for byte, so either package replays
   the other's journal.

``DecodeFleet.from_groups`` (engines over tensor-parallel replica groups)
is not ported: it raises ``NotImplementedError`` (``ROADMAP.md`` §A item
4c).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.resilience.circuit import CLOSED

__all__ = [
    "DecodeFleet",
    "EngineUnhealthy",
    "ReplayedRequest",
    "RequestJournal",
    "RescuePacket",
    "RetriesExhausted",
    "replay_journal",
    "resume_incomplete",
]


class RetriesExhausted(RuntimeError):
    """A request burned through its recovery budget — the fault follows
    it across quarantine cycles, so it is the poison (or rides a dead
    device with nowhere to migrate). Carries the request id so clients
    can correlate with journal/runlog records."""

    def __init__(self, message: str, request_id: Optional[str] = None):
        super().__init__(message)
        self.request_id = request_id


class EngineUnhealthy(RuntimeError):
    """No healthy engine could take the work (fleet exhausted, or the
    engine was killed)."""


@dataclasses.dataclass
class RescuePacket:
    """Everything needed to continue one generation on another engine:
    pure host-side state (the KV cache is rebuilt by re-prefill, which
    the preempt/resume path proves token-exact). ``handle`` is the
    client's original future — migration repoints it at the adopting
    engine's request so ``result()``/``cancel()`` keep working; None
    (journal replay: the old process's futures died with it) makes the
    adopter mint a fresh handle."""

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
    trace: Optional[Any] = None
    cancelled: bool = False


# -- the durable request journal (WAL) --------------------------------------

_J_ADMIT = "admit"
_J_TOK = "tok"
_J_FIN = "fin"
# disaggregated handoff (serving.disagg): a prefill worker published the
# request's KV pages toward a decode worker ("hof", full request snapshot
# — authoritative like an admit record), and the receiving decode worker
# acknowledged adoption ("ack"). A crash between the two leaves the
# request unfinished in replay, so resume_incomplete re-prefills it —
# a handoff in flight is never a lost request.
_J_HOF = "hof"
_J_ACK = "ack"


def _encode_record(obj: Dict[str, Any]) -> bytes:
    payload = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x}|{payload}\n".encode("utf-8")


def _decode_record(line: bytes) -> Optional[Dict[str, Any]]:
    """One journal line -> record dict, or None when the line is torn or
    corrupt (bad CRC, truncated json, missing separator)."""
    try:
        text = line.decode("utf-8")
        crc_hex, payload = text.split("|", 1)
        payload = payload.rstrip("\n")
        if int(crc_hex, 16) != (zlib.crc32(payload.encode("utf-8"))
                                & 0xFFFFFFFF):
            return None
        obj = json.loads(payload)
        return obj if isinstance(obj, dict) else None
    except (ValueError, UnicodeDecodeError):
        return None


class RequestJournal:
    """Append-only WAL of request admissions, generated tokens, and
    terminal outcomes. Same durability discipline as
    ``observability.runlog``: one self-validating record per line
    (``<crc32-hex>|<compact-json>``), written append-only so a crash can
    only tear the final line — :func:`replay_journal` stops at the first
    bad record and trusts everything before it.

    fsync policy: records are buffered through the OS and fsync'd every
    ``fsync_every`` appends (and on :meth:`flush`/:meth:`close`), keeping
    the syscall off the per-token hot path. The window between fsyncs is
    the only durability gap — at most ``fsync_every`` tokens re-decode
    after a crash, which re-prefill makes token-exact anyway.

    ``compact_bytes`` bounds WAL growth: once the file exceeds it, the
    journal is compacted — every request replayed, finished ones dropped,
    and only incomplete ones rewritten (as authoritative admit snapshots
    carrying their generated prefix) into a fresh segment published
    atomically (tmp + fsync + ``os.replace`` + directory fsync). Replay
    over a compacted journal is indistinguishable from replay over the
    full history. None = never compact."""

    def __init__(self, path: str, fsync_every: int = 16,
                 compact_bytes: Optional[int] = None):
        enforce(fsync_every >= 1,
                f"fsync_every must be >= 1, got {fsync_every}")
        enforce(compact_bytes is None or compact_bytes >= 1,
                f"compact_bytes must be >= 1, got {compact_bytes}")
        self.path = path
        self.fsync_every = int(fsync_every)
        self.compact_bytes = compact_bytes
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self._lock = locks.Lock("serving.request_journal")
        self._unsynced = 0
        self._bytes = os.path.getsize(path)
        self.records_total = 0
        self.compactions_total = 0

    def _append(self, obj: Dict[str, Any]) -> None:
        data = _encode_record(obj)
        need_sync = False
        need_compact = False
        with self._lock:
            if self._f.closed:
                return  # journal detached mid-flight (engine killed)
            self._f.write(data)
            self.records_total += 1
            self._unsynced += 1
            self._bytes += len(data)
            if self._unsynced >= self.fsync_every:
                self._unsynced = 0
                need_sync = True
            if (self.compact_bytes is not None
                    and self._bytes >= self.compact_bytes):
                need_compact = True
        if need_sync:
            self._sync()
        if need_compact:
            self.compact()

    def _sync(self) -> None:
        """flush+fsync OUTSIDE the append lock: fsync covers every byte
        written before the call, so a concurrent append only widens the
        sync, never narrows it — and the ms-scale syscall no longer stalls
        other writer threads behind the disk (BufferedWriter serializes
        the flush internally)."""
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (ValueError, OSError):
            pass  # journal closed mid-flight; close() already synced

    def log_admit(self, rid: str, prompt: np.ndarray, mnt: int,
                  gen_prefix: List[int], tenant: str, cls: str,
                  trace: Optional[str] = None) -> None:
        """Request accepted (or adopted with an already-generated prefix
        after migration/replay — ``gen_prefix`` keeps the journal
        self-contained without rewriting token records). ``trace`` is the
        request's W3C traceparent, journaled so a post-crash replay
        resumes under the ORIGINAL trace id instead of minting a fresh
        one — the fleet trace survives the process."""
        rec = {
            "k": _J_ADMIT, "rid": rid,
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "mnt": int(mnt), "gen": [int(t) for t in gen_prefix],
            "tenant": tenant, "cls": cls,
        }
        if trace is not None:
            rec["tp"] = trace
        self._append(rec)

    def log_token(self, rid: str, tok: int) -> None:
        self._append({"k": _J_TOK, "rid": rid, "t": int(tok)})

    def log_finish(self, rid: str, reason: str) -> None:
        self._append({"k": _J_FIN, "rid": rid, "reason": reason})

    def log_handoff(self, rid: str, prompt: np.ndarray, mnt: int,
                    gen_prefix: List[int], tenant: str, cls: str,
                    src: str, dst: Optional[str],
                    trace: Optional[str] = None) -> None:
        """A prefill worker published this request's KV pages toward
        ``dst``. The record carries the full request snapshot (like an
        admit record) so replay of THIS journal alone can re-prefill an
        unacked handoff — durability does not depend on the source
        worker surviving the transfer. ``trace`` keeps the traceparent
        durable alongside it (same contract as :meth:`log_admit`)."""
        rec = {
            "k": _J_HOF, "rid": rid,
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "mnt": int(mnt), "gen": [int(t) for t in gen_prefix],
            "tenant": tenant, "cls": cls, "src": src, "dst": dst,
        }
        if trace is not None:
            rec["tp"] = trace
        self._append(rec)
        self.flush()  # the handoff record must be durable before transfer

    def log_handoff_ack(self, rid: str, dst: str) -> None:
        """The receiving decode worker validated and adopted the pages."""
        self._append({"k": _J_ACK, "rid": rid, "dst": dst})

    def compact(self) -> Dict[str, int]:
        """Rewrite the WAL into a fresh segment containing only incomplete
        requests (each as one authoritative admit snapshot carrying its
        generated prefix); finished requests and their token records are
        dropped. The new segment is published atomically — written to a
        temp file, fsync'd, ``os.replace``'d over the journal, and the
        directory entry fsync'd — so a crash at ANY point leaves either
        the old segment or the complete new one, never a mix. The journal
        lock is held throughout: a compaction is rare (size-triggered)
        and concurrent appends must not land in the segment being
        replaced. Torn-tail safe by construction: replay stops at the
        first corrupt record, so compaction preserves exactly the state a
        post-crash replay would recover. Returns
        ``{"kept": .., "dropped": .., "bytes": ..}``."""
        with self._lock:
            if self._f.closed:
                return {"kept": 0, "dropped": 0, "bytes": 0}
            try:
                self._f.flush()
                os.fsync(self._f.fileno())  # lint: allow — rare, must be atomic vs appends
            except (ValueError, OSError):
                return {"kept": 0, "dropped": 0, "bytes": 0}
            replayed = replay_journal(self.path)
            tmp = f"{self.path}.compact.{os.getpid()}"
            kept = 0
            with open(tmp, "wb") as f:  # lint: allow — rare, must be atomic vs appends
                for rid, rr in replayed.items():
                    if rr.finished:
                        continue
                    snap = {
                        "k": _J_ADMIT, "rid": rid,
                        "prompt": [int(t) for t in rr.prompt],
                        "mnt": int(rr.mnt),
                        "gen": [int(t) for t in rr.generated],
                        "tenant": rr.tenant, "cls": rr.cls,
                    }
                    if rr.trace is not None:
                        snap["tp"] = rr.trace
                    f.write(_encode_record(snap))
                    kept += 1
                f.flush()
                os.fsync(f.fileno())  # lint: allow — rare, must be atomic vs appends
            old = self._f
            os.replace(tmp, self.path)  # lint: allow — rare, must be atomic vs appends
            dpath = os.path.dirname(os.path.abspath(self.path)) or "."
            dfd = os.open(dpath, os.O_RDONLY)
            try:
                os.fsync(dfd)  # lint: allow — rare, must be atomic vs appends
            finally:
                os.close(dfd)
            old.close()
            self._f = open(self.path, "ab")  # lint: allow — rare, must be atomic vs appends
            self._bytes = os.path.getsize(self.path)
            self._unsynced = 0
            self.compactions_total += 1
            dropped = len(replayed) - kept
            nbytes = self._bytes
        runlog.emit("journal_compacted", path=self.path, kept=kept,
                    dropped=dropped, bytes=nbytes)
        return {"kept": kept, "dropped": dropped, "bytes": nbytes}

    def flush(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._unsynced = 0
        self._sync()

    def close(self) -> None:
        self._sync()
        with self._lock:
            if not self._f.closed:
                self._f.close()


@dataclasses.dataclass
class ReplayedRequest:
    """One request reconstructed from the journal. ``handed_off``/
    ``acked`` expose the disaggregated-handoff state: a request that was
    handed off but never acked was in flight between workers at the
    crash — it is NOT finished, so :func:`resume_incomplete` re-prefills
    it (the zero-loss handoff contract)."""

    rid: str
    prompt: np.ndarray
    mnt: int
    generated: List[int]
    tenant: str = "default"
    cls: str = "interactive"
    finished: bool = False
    reason: Optional[str] = None
    handed_off: bool = False
    acked: bool = False
    trace: Optional[str] = None  # W3C traceparent from the admit/hof record


def replay_journal(path: str) -> Dict[str, ReplayedRequest]:
    """Reconstruct request state from a journal file, in admission order.
    Torn-tail tolerant: reading stops at the first corrupt record (a
    crash mid-append can only damage the tail; anything after a bad
    record is untrusted). A re-``admit`` of a known rid (migration across
    engines sharing a journal, or an adopted prefix) resets that
    request's token prefix to the record's ``gen`` — admission records
    are authoritative snapshots, token records are increments."""
    out: Dict[str, ReplayedRequest] = {}
    if not os.path.exists(path):
        return out
    n_bad = 0
    with open(path, "rb") as f:
        for line in f:
            rec = _decode_record(line)
            if rec is None:
                n_bad += 1
                break  # torn tail: trust nothing past the first bad record
            kind, rid = rec.get("k"), rec.get("rid")
            if kind == _J_ADMIT:
                out[rid] = ReplayedRequest(
                    rid=rid,
                    prompt=np.asarray(rec.get("prompt", []), np.int32),
                    mnt=int(rec.get("mnt", 0)),
                    generated=[int(t) for t in rec.get("gen", [])],
                    tenant=rec.get("tenant", "default"),
                    cls=rec.get("cls", "interactive"),
                    trace=rec.get("tp"),
                )
            elif kind == _J_TOK and rid in out:
                out[rid].generated.append(int(rec.get("t", 0)))
            elif kind == _J_FIN and rid in out:
                out[rid].finished = True
                out[rid].reason = rec.get("reason")
            elif kind == _J_HOF:
                # authoritative snapshot at publish time, like an admit —
                # a prefill worker may hand off a request this journal
                # never saw admitted (per-worker journals)
                rr = out.get(rid)
                if rr is None:
                    rr = out[rid] = ReplayedRequest(
                        rid=rid, prompt=np.asarray(
                            rec.get("prompt", []), np.int32),
                        mnt=int(rec.get("mnt", 0)), generated=[],
                        tenant=rec.get("tenant", "default"),
                        cls=rec.get("cls", "interactive"))
                rr.generated = [int(t) for t in rec.get("gen", [])]
                rr.handed_off = True
                rr.acked = False
                if rec.get("tp") is not None:
                    rr.trace = rec.get("tp")
            elif kind == _J_ACK and rid in out:
                out[rid].acked = True
    if n_bad:
        ptlog.warning("journal %s: stopped at a torn/corrupt record "
                      "(%d request(s) recovered before it)", path, len(out))
    return out


def _trace_from_traceparent(tracing_mod, header: Optional[str]):
    """Journaled traceparent -> SpanContext, or None when the record
    predates trace journaling or carries a malformed header (a corrupt
    trace must never block replay of an otherwise-valid request)."""
    if not header:
        return None
    try:
        return tracing_mod.SpanContext.from_traceparent(header)
    except Exception:
        return None


def resume_incomplete(engine, path: str) -> Dict[str, Tuple[Any, int]]:
    """Resubmit every journaled-but-unfinished request on ``engine``
    (typically a fresh process over the same journal file). Returns
    ``rid -> (handle, n_delivered)`` where ``n_delivered`` is how many
    tokens the journal proves were already produced — the idempotent-id
    dedup contract: the resumed output's first ``n_delivered`` tokens are
    exactly the ones a client may already have received, so a delivery
    layer replays ``tokens[n_delivered:]`` only."""
    from paddle_tpu_torch import tracing

    replayed = replay_journal(path)
    out: Dict[str, Tuple[Any, int]] = {}
    for rid, rr in replayed.items():
        if rr.finished:
            continue
        packet = RescuePacket(
            rid=rid, prompt=rr.prompt, mnt=rr.mnt,
            generated=list(rr.generated), tenant=rr.tenant, cls=rr.cls,
            t_submit=time.monotonic(),
            trace=_trace_from_traceparent(tracing, rr.trace),
        )
        handle = engine.adopt_rescue(packet)
        out[rid] = (handle, len(rr.generated))
    engine.metrics.record_journal_replayed(len(out))
    runlog.emit("journal_replay", engine=engine.metrics.engine_label,
                path=path, resumed=len(out),
                finished=len(replayed) - len(out))
    return out


# -- cross-engine migration --------------------------------------------------

class DecodeFleet:
    """A set of ``DecodeEngine``\\ s behind one submit surface, with
    health-aware routing and rescue. Each engine keeps its own
    ``CircuitBreaker``; routing picks the least-loaded CLOSED breaker
    (live slots + queued/parked depth, ``DecodeEngine.load()``) and
    spends at most one half-open probe per pick on a cooled-down OPEN
    one, so a recovered device earns its traffic back one request at a
    time. When an engine declares itself unhealthy it drains its live
    requests into :class:`RescuePacket`\\ s and hands them here —
    :meth:`_rescue` re-places each on a healthy peer with the client's
    original handle intact."""

    def __init__(self, engines: List[Any]):
        enforce(len(engines) >= 1, "DecodeFleet needs at least one engine")
        self.engines = list(engines)
        self._rr = 0
        self._lock = locks.Lock("serving.decode_fleet")
        # engines mid drain-and-convert (serving.disagg): excluded from
        # routing while their graceful drain runs
        self._draining: set = set()
        self.rescued_total = 0
        self.rescue_failed_total = 0
        for eng in self.engines:
            eng._rescue_sink = self._rescue

    @classmethod
    def from_groups(cls, variables, model_cfg, groups, **kwargs) -> "DecodeFleet":
        """One engine per tensor-parallel replica group
        (``serving.shardgroup``): not ported yet."""
        raise NotImplementedError(
            "DecodeFleet.from_groups (serving.shardgroup replica groups) is "
            "not ported to paddle_tpu_torch yet (ROADMAP.md §A item 4c)")

    def _order(self, candidates: Optional[List[Any]] = None) -> List[Any]:
        """Rotating view over ``candidates`` (default: every engine) —
        keeps half-open probes fair when several breakers cool down at
        once; the load ranking below is order-independent."""
        engines = list(self.engines if candidates is None else candidates)
        with self._lock:
            k = self._rr
            self._rr += 1
        n = len(engines)
        return [engines[(k + i) % n] for i in range(n)] if n else []

    def _pick(self, exclude: Optional[Any] = None,
              candidates: Optional[List[Any]] = None,
              prompt: Optional[Any] = None) -> Optional[Any]:
        order = [e for e in self._order(candidates)
                 if e is not exclude and not e.closed
                 and id(e) not in self._draining]
        # spend a half-open probe the moment one is available — even with
        # healthy engines around, one risked request is how an ejected
        # engine earns its capacity back (a failed probe just re-opens
        # the breaker, and recovery/migration makes the request itself
        # zero-loss). allow() takes the single probe token atomically.
        healthy = []
        for eng in order:
            if eng.breaker.state == CLOSED:
                healthy.append(eng)
            elif eng.breaker.retry_in() == 0.0 and eng.breaker.allow():
                return eng
        if not healthy:
            return None
        # least-loaded over CLOSED breakers: a saturated engine stops
        # receiving new work while a peer has capacity. Ties break on the
        # engine's stable fleet index, NOT the rotated order — the rotation
        # exists for half-open-probe fairness above, but letting it leak
        # into the load ranking made equal-load placement depend on how
        # many picks had ever happened, so identical traffic replayed onto
        # different engines run-to-run.
        pos = {id(e): i for i, e in enumerate(self.engines)}
        n = len(self.engines)
        # prefix-aware routing: rank by the longest cached prefix of the
        # prompt first (engines publish compact per-prefix digest sets
        # when DecodeConfig.prefix_digest is on; others match depth 0),
        # then least-loaded, then stable index. A digest is advisory —
        # worst case the match is stale and the engine just prefills, so
        # routing optimality degrades but never correctness.
        depth = self._match_depth_fn(prompt) if prompt is not None else None
        if depth is not None:
            return min(healthy, key=lambda e: (-depth(e), e.load(),
                                               pos.get(id(e), n)))
        return min(healthy, key=lambda e: (e.load(), pos.get(id(e), n)))

    @staticmethod
    def _match_depth_fn(prompt) -> Optional[Any]:
        """Cached-prefix depth scorer for one prompt, or None when no
        digest chain applies. Digest chains are memoized per page size —
        a homogeneous fleet computes the CRC chain once per submit."""
        from paddle_tpu_torch.serving.host_tier import prefix_digests
        memo: Dict[int, List[int]] = {}

        def depth(eng) -> int:
            match = getattr(eng, "prefix_match_depth", None)
            dconf = getattr(eng, "decode_config", None)
            if match is None or dconf is None:
                return 0
            ps = dconf.page_size
            if ps not in memo:
                memo[ps] = prefix_digests(prompt, ps)
            return match(memo[ps])

        return depth

    def submit(self, prompt, max_new_tokens: int, **kwargs):
        eng = self._pick(prompt=prompt)
        if eng is None:
            raise EngineUnhealthy(
                "no healthy decode engine (all breakers open or cooling)")
        return eng.submit(prompt, max_new_tokens, **kwargs)

    def _rescue(self, src, packets: List[RescuePacket]) -> int:
        """Re-place drained requests anywhere but ``src``. A packet with
        no healthy destination fails its handle with
        :class:`EngineUnhealthy` — zero-loss holds as long as one healthy
        engine exists."""
        adopted = 0
        for packet in packets:
            dst = self._pick(exclude=src)
            if dst is None:
                self.rescue_failed_total += 1
                if packet.handle is not None:
                    packet.handle._fail(EngineUnhealthy(
                        f"request {packet.rid}: engine "
                        f"{src.metrics.engine_label} unhealthy and no "
                        f"healthy engine to migrate to"))
                continue
            dst.adopt_rescue(packet, from_engine=src.metrics.engine_label)
            adopted += 1
            self.rescued_total += 1
        return adopted

    def snapshot(self) -> Dict[str, Any]:
        return {
            "engines": [
                {"engine": e.metrics.engine_label,
                 "breaker": e.breaker.snapshot(),
                 "closed": e.closed}
                for e in self.engines
            ],
            "rescued_total": self.rescued_total,
            "rescue_failed_total": self.rescue_failed_total,
        }

    def close(self, timeout: Optional[float] = None) -> List[str]:
        unjoined: List[str] = []
        for eng in self.engines:
            unjoined.extend(eng.close(timeout))
        return unjoined

    def __enter__(self) -> "DecodeFleet":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self.close()
        return False
