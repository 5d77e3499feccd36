"""Hierarchical KV: a bounded host-RAM page pool behind the radix
prefix cache, doubling as the fleet's crash-recovery substrate — port of
``paddle_tpu.serving.host_tier``.

The radix prefix cache (``serving.prefix_cache``) is bounded by one
card's page pool and private to one engine: an evicted system prompt
re-prefills from scratch, two engines never share a warm prefix, and
when an engine dies its whole warm tree dies with it. The reference
framework's memory layer exists for exactly this shape of problem — its
buddy allocator spans CPUPlace/CUDAPinnedPlace so hot device state can
stage through host RAM. :class:`HostPagePool` is that tier for KV pages:

- **Demote (write-through).** When an engine publishes a finished
  prefill into its radix tree it also gathers the fully-written pages
  off-device and stores them here, keyed by the page-aligned token
  prefix they encode. Eviction from the radix tree therefore costs
  nothing extra — the evicted page's bytes are already resident in the
  host tier.
- **Promote (asynchronous).** On a radix miss whose continuation the
  pool holds, the engine enqueues a promote job and answers the request
  by prefilling as usual (token-exact either way). The loop thread
  applies a bounded number of promotions per iteration off the step
  path: allocate a device page, implant the host bytes, insert into the
  tree — the NEXT request with that prefix hits in HBM.
- **Integrity.** Every stored page carries a CRC32 per K/V blob —
  the same self-validating discipline as
  :class:`~paddle_tpu_torch.serving.disagg.HandoffPayload`. A bit-flipped
  host page fails verification at promote time and is quarantined
  (dropped + counted), and the request re-prefills token-exactly rather
  than trusting corrupt KV state.
- **Recovery.** Because demotion is write-through for completed prefill
  pages, a pool SHARED across a fleet survives any one engine's
  ``kill()``: after journal replay, the restarted (or surviving) engine
  repopulates its radix tree from the host tier instead of re-prefilling
  the world — the recovery ladder's adopt-from-host-tier rung, between
  "re-prefill locally" and "migrate".

Unlike the allocator and the radix tree (single-loop-thread state), the
pool is shared across engines and therefore thread-safe: one named
``core.locks`` lock guards the entry map. CRC computation and
verification run OUTSIDE the lock — blobs are immutable ``bytes``, so a
reader can validate its snapshot lock-free and a stall injected on the
demote path never extends the lock hold.

Pages are kept as raw bytes beside their dtype's name, as the JAX package
writes them (``"float32"``, ``"bfloat16"``): numpy has no bf16 dtype
without ``ml_dtypes``, which the port does not use, so a page comes back as
a CPU ``torch.Tensor`` rebuilt with ``torch.frombuffer``
(:func:`page_blob`, :func:`page_from_blob`).

Keys are the full page-aligned token prefixes (exact-match by
construction — no hash collision can alias two prompts onto one page).
:func:`prefix_digests` derives the compact per-prefix digests the
prefix-aware fleet routing publishes and matches on.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes, locks
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.resilience import faults

__all__ = ["HostPagePool", "HostPage", "HostPageCorrupt", "prefix_digests",
           "page_blob", "page_from_blob"]


def page_blob(page: torch.Tensor) -> Tuple[bytes, Tuple[int, ...], str]:
    """One KV page (a tensor on any device) as ``(raw bytes, shape, dtype
    name)``: the bytes the JAX package writes for the same values
    (``np.ascontiguousarray(page).tobytes()``) and its dtype string,
    ``"bfloat16"`` included."""
    t = page.detach().contiguous().cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return raw, tuple(t.shape), str(t.dtype).replace("torch.", "")


def page_from_blob(blob: bytes, shape: Sequence[int], dtype: str) -> torch.Tensor:
    """Inverse of :func:`page_blob`: a CPU tensor of ``dtype`` (a name
    such as ``"float32"`` or ``"bfloat16"``) and ``shape`` over a copy of
    ``blob``."""
    return torch.frombuffer(bytearray(blob), dtype=dtypes.convert(dtype)).reshape(tuple(shape))


class HostPageCorrupt(RuntimeError):
    """A host page failed CRC verification at promote time (bit-flipped
    host memory, or the injected corrupt-on-promote fault). The entry is
    already quarantined when this raises — the caller must re-prefill
    the span token-exactly instead of adopting the page."""


def prefix_digests(tokens: Sequence[int], page_size: int) -> List[int]:
    """Running CRC32 digest per page-aligned token prefix of ``tokens``:
    ``out[i]`` identifies ``tokens[:(i+1) * page_size]``. The compact
    form engines publish for prefix-aware routing — a fleet compares a
    prompt's digest chain against each engine's published set and routes
    to the longest match."""
    ps = int(page_size)
    enforce(ps >= 1, f"page_size must be >= 1, got {ps}")
    arr = np.asarray(tokens, np.int32).reshape(-1)
    out: List[int] = []
    crc = 0
    for i in range(len(arr) // ps):
        crc = zlib.crc32(arr[i * ps:(i + 1) * ps].tobytes(), crc)
        out.append(crc & 0xFFFFFFFF)
    return out


class HostPage:
    """One demoted KV page: the K and V blobs for ``page_size`` tokens,
    each CRC-protected, keyed by the exact token prefix they encode."""

    __slots__ = ("key", "k_blob", "v_blob", "k_crc", "v_crc",
                 "shape", "dtype", "nbytes")

    def __init__(self, key: Tuple[int, ...], k_blob: bytes, v_blob: bytes,
                 shape: Tuple[int, ...], dtype: str):
        self.key = key
        self.k_blob = k_blob
        self.v_blob = v_blob
        self.k_crc = zlib.crc32(k_blob) & 0xFFFFFFFF
        self.v_crc = zlib.crc32(v_blob) & 0xFFFFFFFF
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.nbytes = len(k_blob) + len(v_blob)


class HostPagePool:
    """Byte-bounded LRU store of demoted KV pages, shared across a
    fleet. Thread-safe (named lock); CRC verify/compute stay outside the
    lock. ``page_size`` pins the geometry — a pool never serves an
    engine with a different page size (the caller enforces via
    :meth:`compatible`)."""

    def __init__(self, max_bytes: int, page_size: int):
        enforce(max_bytes > 0, f"max_bytes must be > 0, got {max_bytes}")
        enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        self.max_bytes = int(max_bytes)
        self.page_size = int(page_size)
        self._lock = locks.Lock("serving.host_tier")
        self._entries: "OrderedDict[Tuple[int, ...], HostPage]" = OrderedDict()
        self._bytes = 0
        # counters (read via stats(); the engine mirrors them into
        # serving.host_tier.* metric families)
        self.puts_total = 0
        self.hits_total = 0
        self.misses_total = 0
        self.evicted_total = 0
        self.quarantined_total = 0
        self.backpressure_total = 0

    # -- geometry ----------------------------------------------------------

    def compatible(self, page_size: int) -> bool:
        return int(page_size) == self.page_size

    @staticmethod
    def _key(tokens: Sequence[int], n_pages: int,
             page_size: int) -> Tuple[int, ...]:
        arr = np.asarray(tokens, np.int32).reshape(-1)
        return tuple(int(t) for t in arr[:n_pages * page_size])

    # -- readout -----------------------------------------------------------

    @property
    def num_pages(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pages": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "puts": self.puts_total,
                "hits": self.hits_total,
                "misses": self.misses_total,
                "evicted": self.evicted_total,
                "quarantined": self.quarantined_total,
                "backpressure": self.backpressure_total,
            }

    def contains(self, tokens: Sequence[int], n_pages: int) -> bool:
        """Does the pool hold the ``n_pages``-th page of this prefix
        (page index ``n_pages - 1``)? Cheap probe used at admission to
        decide whether a promote job is worth enqueueing."""
        key = self._key(tokens, n_pages, self.page_size)
        if len(key) < n_pages * self.page_size:
            return False
        with self._lock:
            return key in self._entries

    # -- demote (write-through insert) -------------------------------------

    def put(self, tokens: Sequence[int], page_index: int, k_page, v_page,
            **ctx) -> Dict[str, int]:
        """Store logical page ``page_index`` of the page-aligned prefix
        of ``tokens`` (``k_page``/``v_page``: tensors on any device).
        Returns ``{"added": 0|1, "evicted": n}`` —
        ``added=0`` means the page was already resident (dedup:
        re-demoting a shared system prompt is a no-op).

        Inserting past ``max_bytes`` LRU-evicts; when the insert itself
        triggered eviction, the demote-backpressure counter bumps — a
        sustained climb means the working set outgrew the tier (the
        ``watch`` rule subscribes to the mirrored metric family)."""
        # chaos: stall-on-demote fires HERE, before the lock — a slow
        # host tier must never extend the pool's lock hold
        faults.inject(faults.HOST_TIER, op="demote", **ctx)
        key = self._key(tokens, page_index + 1, self.page_size)
        enforce(len(key) == (page_index + 1) * self.page_size,
                f"put: page {page_index} needs "
                f"{(page_index + 1) * self.page_size} tokens, "
                f"got {len(key)}")
        k_blob, k_shape, k_dtype = page_blob(k_page)
        v_blob, v_shape, _ = page_blob(v_page)
        enforce(k_shape == v_shape,
                f"put: K/V shape mismatch {k_shape} vs {v_shape}")
        entry = HostPage(key, k_blob, v_blob, k_shape, k_dtype)
        enforce(entry.nbytes <= self.max_bytes,
                f"put: one page ({entry.nbytes}B) exceeds the pool "
                f"budget ({self.max_bytes}B)")
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return {"added": 0, "evicted": 0}
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self.puts_total += 1
            evicted = 0
            while self._bytes > self.max_bytes:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                evicted += 1
            if evicted:
                self.evicted_total += evicted
                self.backpressure_total += 1
        return {"added": 1, "evicted": evicted}

    # -- promote (verified read) -------------------------------------------

    def get(self, tokens: Sequence[int], page_index: int,
            **ctx) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Fetch logical page ``page_index`` of the prefix, CRC-verified.
        Returns ``(k_page, v_page)`` (CPU tensors) or None on a miss. A CRC mismatch
        (bit-flipped host memory — or the injected corrupt-on-promote
        fault) quarantines the entry (dropped + counted) and raises
        :class:`HostPageCorrupt` — the caller re-prefills token-exactly
        instead of trusting it."""
        key = self._key(tokens, page_index + 1, self.page_size)
        if len(key) < (page_index + 1) * self.page_size:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses_total += 1
                return None
            self._entries.move_to_end(key)
        # chaos: corrupt-on-promote ("nan" kind) — the fetched bytes are
        # poisoned BEFORE verification, so the CRC check must catch it.
        # Injected on the HIT path only (after the lookup, outside the
        # lock): the fault models the host-memory copy, which a miss
        # never performs — and hit-only firing keeps ``times=N`` specs
        # deterministic for the chaos harness.
        spec = faults.inject(faults.HOST_TIER, op="promote", **ctx)
        k_blob, v_blob = entry.k_blob, entry.v_blob
        if spec is not None and spec.kind == "nan":
            k_blob = bytes([k_blob[0] ^ 0xFF]) + k_blob[1:]
        # verify OUTSIDE the lock: blobs are immutable bytes
        if (zlib.crc32(k_blob) & 0xFFFFFFFF) != entry.k_crc or \
                (zlib.crc32(v_blob) & 0xFFFFFFFF) != entry.v_crc:
            self.quarantine(key)
            raise HostPageCorrupt(
                f"host page for prefix of {len(key)} tokens failed CRC "
                f"verification; quarantined")
        with self._lock:
            self.hits_total += 1
        return (page_from_blob(k_blob, entry.shape, entry.dtype),
                page_from_blob(v_blob, entry.shape, entry.dtype))

    def quarantine(self, key: Tuple[int, ...]) -> None:
        """Drop one entry as untrusted (CRC mismatch). Idempotent."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
                self.quarantined_total += 1

    def clear(self) -> int:
        """Drop every entry (tests / operator reset). Returns the number
        dropped. NOT called by engine ``kill()``/``close()`` — the whole
        point of the tier is surviving an engine's death."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            return n
