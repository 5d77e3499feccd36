"""Radix prefix cache: share prompt-prefix KV pages across requests.

A copy of ``paddle_tpu.serving.prefix_cache`` (jax-free) for the PyTorch
port.

At serving scale most prompts open with the same system prompt / few-shot
preamble, yet a plain engine prefills every request from token zero. This
module keeps a token-keyed radix tree over *physical pages* of the paged
KV cache: each tree node owns one ``page_size``-token chunk of some
previously-prefilled prompt and holds one :class:`PageAllocator` reference
on the physical page containing that chunk's K/V. A new request walks the
tree with its prompt tokens; every matched node is a page of prefill it
can skip, adopted into the slot's page table via
:meth:`PagedKVCache.adopt_pages` (which takes a second ref — the page is
now shared between the tree and the slot).

Granularity is deliberately page-level, matching the cache's unit of
allocation: a partial-page hit would require sub-page masking in the
decode step, which would break the fixed-shape discipline. The tree
therefore only ever holds *fully-written, immutable* pages — the engine
inserts ``len(seq) // page_size`` pages when a prompt finishes prefill,
never the trailing partial page.

Sharing is copy-on-write. A slot writes into an adopted page only when a
prefill continuation chunk straddles the hit boundary; the engine then
calls :meth:`PagedKVCache.private_copy` and re-writes the straddled span
into the private page. Tree refs are dropped by :meth:`evict` (LRU,
leaf-first, so a prefix is never orphaned from its extension) and
:meth:`clear` (engine teardown — after which ``assert_no_leaks`` holds
again). Evicting a page some slot still maps is safe: the allocator
refcount keeps the page alive until the last slot releases it.

Like the allocator, this is host-side state touched only by the engine's
single loop thread — no locking.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.serving.kv_cache import PageAllocator

__all__ = ["RadixPrefixCache"]


class _Node:
    """One cached page: ``key`` is the page's token chunk, ``page`` the
    physical page id the tree holds a ref on. ``digest`` is the running
    CRC32 of the full token prefix this node terminates (chained from
    the parent's digest) — the unit of the compact prefix digest the
    fleet's prefix-aware routing matches against."""

    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "digest")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.digest = 0


class RadixPrefixCache:
    """Token-prefix radix tree over refcounted KV pages.

    ``max_pages`` bounds how many pages the tree may pin; inserts beyond
    the bound evict least-recently-used leaves first. ``None`` leaves the
    tree unbounded — the engine still evicts on allocator pressure before
    resorting to preemption.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_pages: Optional[int] = None):
        enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_pages = None if max_pages is None else int(max_pages)
        self._root = _Node((), -1, None)
        self._nodes: List[_Node] = []  # all non-root nodes, for evict scans
        self._tick = 0
        # per-node prefix digests (see _Node.digest) and a version stamp
        # bumped on every membership change — the engine republishes its
        # routing digest only when this moved
        self._digests: Set[int] = set()
        self.digest_version = 0
        # counters surfaced through DecodeMetrics / bench
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- readout -----------------------------------------------------------

    @property
    def num_pages(self) -> int:
        return len(self._nodes)

    def digests(self) -> frozenset:
        """Immutable snapshot of the per-prefix digests currently cached
        (one per node — the page-aligned token prefix it terminates).
        The engine publishes this for prefix-aware fleet routing; take a
        fresh snapshot after ``digest_version`` moves."""
        return frozenset(self._digests)

    def stats(self) -> Dict[str, int]:
        return {
            "pages": self.num_pages,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "inserts": self.inserts,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }

    # -- core --------------------------------------------------------------

    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> List[int]:
        """Longest page-granular cached prefix of ``tokens``: the physical
        page ids, in logical order. Touches the matched path for LRU."""
        self.lookups += 1
        ps = self.page_size
        limit = len(tokens) // ps
        if max_pages is not None:
            limit = min(limit, max_pages)
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for i in range(limit):
            key = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * ps
        return pages

    def peek(self, tokens: Sequence[int],
             max_pages: Optional[int] = None) -> List[int]:
        """:meth:`match` without the stat bumps or LRU touch — internal
        probes (e.g. the host-tier promote apply path re-checking current
        tree depth) must not inflate hit-rate counters or keep a prefix
        artificially warm."""
        ps = self.page_size
        limit = len(tokens) // ps
        if max_pages is not None:
            limit = min(limit, max_pages)
        node = self._root
        pages: List[int] = []
        for i in range(limit):
            key = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Record ``pages`` (the slot's first ``len(pages)`` logical pages,
        fully written with the K/V of ``tokens``) under their token path.
        Chunks already present are left as-is — dedup falls out of the
        walk, so re-inserting a shared prefix never double-refs. Returns
        the number of *new* pages the tree took a reference on."""
        ps = self.page_size
        enforce(len(tokens) >= len(pages) * ps,
                f"insert: {len(pages)} pages need {len(pages) * ps} tokens, "
                f"got {len(tokens)}")
        self.inserts += 1
        self._tick += 1
        node = self._root
        added = 0
        for i, page in enumerate(pages):
            key = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                self.allocator.ref([page])
                child = _Node(key, int(page), node)
                child.digest = zlib.crc32(
                    np.asarray(key, np.int32).tobytes(),
                    node.digest) & 0xFFFFFFFF
                node.children[key] = child
                self._nodes.append(child)
                self._digests.add(child.digest)
                added += 1
            child.last_used = self._tick
            node = child
        self.inserted_pages += added
        if added:
            self.digest_version += 1
        if self.max_pages is not None and self.num_pages > self.max_pages:
            self.evict(pages_needed=0,
                       max_evictions=self.num_pages - self.max_pages)
        return added

    def evict(self, pages_needed: int = 1,
              max_evictions: Optional[int] = None) -> int:
        """Drop LRU leaves until ``pages_needed`` pages have actually
        returned to the allocator's free list (a leaf some slot still maps
        frees no capacity — its refcount stays positive) or the tree is
        empty. ``max_evictions`` instead bounds the number of leaves
        dropped regardless of freed capacity (size-cap trimming). Returns
        the number of pages returned to the free list."""
        freed = 0
        dropped = 0
        while self._nodes:
            if max_evictions is not None and dropped >= max_evictions:
                break
            if max_evictions is None and freed >= pages_needed:
                break
            leaf = min((n for n in self._nodes if not n.children),
                       key=lambda n: n.last_used, default=None)
            if leaf is None:  # cannot happen: a finite tree has leaves
                break
            before = self.allocator.num_free
            self.allocator.free([leaf.page])
            freed += self.allocator.num_free - before
            dropped += 1
            leaf.parent.children.pop(leaf.key, None)
            self._nodes.remove(leaf)
            self._digests.discard(leaf.digest)
        self.evicted_pages += dropped
        if dropped:
            self.digest_version += 1
        return freed

    def clear(self) -> int:
        """Drop every tree reference (engine teardown). Returns the number
        of nodes dropped. Pages still mapped by live slots survive until
        those slots release."""
        n = len(self._nodes)
        for node in self._nodes:
            self.allocator.free([node.page])
        self._nodes.clear()
        self._root.children.clear()
        self._digests.clear()
        if n:
            self.digest_version += 1
        self.evicted_pages += n
        return n
