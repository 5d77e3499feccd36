"""Paged KV cache: fixed-size pages + per-sequence page tables, so the
decode step's shapes never depend on which requests are in flight.

A copy of ``paddle_tpu.serving.kv_cache`` (host bookkeeping in numpy,
jax-free) for the PyTorch port.

The static cache in :func:`models.transformer_lm.generate` allocates
``[L, B, H_kv, Tp + max_new_tokens, dh]`` per *batch*: every sequence in
the batch owns a contiguous region sized for the worst case, and its shapes
are specialized to ``(B, T_max)``. That is the wrong shape discipline for
continuous batching, where the set of in-flight sequences changes every
iteration.

Here device memory is carved into ``num_pages`` fixed ``page_size``-token pages
(``k_pages``/``v_pages``: ``[L, num_pages, H_kv, page_size, dh]``), and
each of ``max_slots`` sequence slots holds a page *table* — an int32 row
of physical page ids, one per logical page. The decode step takes
``(tokens [S], positions [S], page_tables [S, P], k_pages, v_pages)``:
every shape is a function of static config only, so the step has one
shape and admission/eviction between steps never changes it.
Attention gathers a sequence's pages through its table row and masks
positions ``> seq_len``; writes scatter one token's K/V into
``table[pos // page_size]`` at offset ``pos % page_size``.

Page 0 is reserved scratch: inactive slots point their whole table at it
and their (garbage) writes land there harmlessly, so the step needs no
per-slot branching. The allocator hands out pages ``1..num_pages-1``
from a free list; :meth:`PageAllocator.assert_empty` is the no-leak
invariant the drain tests pin.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["PageAllocator", "PagedKVCache", "SCRATCH_PAGE"]

# physical page 0: never allocated; inactive slots write/read it
SCRATCH_PAGE = 0


class PageAllocator:
    """Free-list allocator over the physical page pool (host-side, not
    thread-safe — the decode loop is the only caller). Allocation is
    all-or-nothing: ``alloc(n)`` returns ``n`` page ids or ``None``
    without splitting, so a failed grow never leaks a partial grant."""

    def __init__(self, num_pages: int):
        enforce(num_pages >= 2,
                f"need >= 2 pages (page {SCRATCH_PAGE} is reserved scratch), "
                f"got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free list: recently-freed (cache-warm) pages are reused first
        self._free: List[int] = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        # refcount per page: 0 = free. Prefix sharing holds extra refs on a
        # page (the radix tree plus every slot whose table maps it), and the
        # page returns to the free list only when the last ref drops.
        self._refs = [0] * num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def refcounts(self) -> List[int]:
        """Copy of every page's refcount (diagnostics; the host-tier
        promote tests pin the ownership-handoff discipline with this).

        The handoff pattern for loading externally-held page bytes (host
        tier promote, handoff adoption into a cache structure): the
        loader ``alloc(1)``\\ s the page (ref 1, loader-owned), implants
        the bytes, hands ownership to the long-lived holder (e.g.
        ``RadixPrefixCache.insert`` takes its own ref → 2), then
        ``free``\\ s its loader ref (→ 1, holder-owned). If the holder
        declined the page (already cached), the final ``free`` returns
        it to the pool — never a leak, never a double-own."""
        return list(self._refs)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` distinct page ids (each with refcount 1), or None if fewer
        than ``n`` are free."""
        enforce(n >= 0, f"alloc: n must be >= 0, got {n}")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def ref(self, pages: Sequence[int]) -> None:
        """Take an extra reference on already-allocated pages (prefix
        sharing: a cache hit maps the same physical page into another
        slot's table)."""
        for p in pages:
            enforce(SCRATCH_PAGE < p < self.num_pages,
                    f"ref: page id {p} out of range")
            enforce(self._refs[p] > 0,
                    f"ref: page {p} is not allocated")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the pool when its
        refcount hits 0. Freeing an unallocated page or scratch is a
        programming error and raises (a silently-tolerated double free
        would hand one physical page to two sequences later)."""
        for p in pages:
            enforce(SCRATCH_PAGE < p < self.num_pages,
                    f"free: page id {p} out of range")
            enforce(self._refs[p] > 0, f"free: page {p} is not allocated "
                    "(double free?)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def assert_empty(self) -> None:
        """The no-leak invariant: after a full drain every page is back in
        the free list."""
        leaked = [i for i, r in enumerate(self._refs) if r > 0]
        enforce(not leaked,
                f"page leak after drain: {len(leaked)} page(s) still "
                f"allocated: {leaked[:8]}")


class PagedKVCache:
    """Host-side bookkeeping for the paged cache: slot lifecycle, page
    tables, and sequence lengths. The device arrays themselves
    (``k_pages``/``v_pages``) are created and updated in place by the
    engine's step — this class only decides *which* physical pages
    each slot's logical positions map to.

    A slot's logical capacity is ``pages_per_slot * page_size`` tokens
    (``pages_per_slot`` is the static page-table width ``P``). Pages are
    granted lazily by :meth:`ensure_capacity` as the sequence grows, so a
    short request never reserves worst-case HBM.
    """

    def __init__(self, *, max_slots: int, page_size: int, num_pages: int,
                 pages_per_slot: int):
        enforce(max_slots >= 1, f"max_slots must be >= 1, got {max_slots}")
        enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        enforce(pages_per_slot >= 1,
                f"pages_per_slot must be >= 1, got {pages_per_slot}")
        # one fully-grown sequence must always fit, else a lone request
        # could deadlock against an exhausted pool with nothing to preempt
        enforce(num_pages - 1 >= pages_per_slot,
                f"num_pages ({num_pages}) must exceed pages_per_slot "
                f"({pages_per_slot}): one max-length sequence has to fit "
                "even with every other slot evicted")
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.max_context = self.pages_per_slot * self.page_size
        self.allocator = PageAllocator(num_pages)
        self.page_tables = np.full((max_slots, pages_per_slot), SCRATCH_PAGE,
                                   dtype=np.int32)
        self.seq_lens = np.zeros((max_slots,), dtype=np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._active = [False] * max_slots
        # logical page indices this slot shares with the prefix cache (or
        # other slots): writes into these must copy-on-write first
        self._slot_shared: List[set] = [set() for _ in range(max_slots)]

    def geometry(self) -> dict:
        """The cache's shape contract as a plain dict. Two caches with
        equal geometry index the same logical pages — the invariant the
        tp replica groups lean on: page ids are global across a group
        (only KV *heads* are sharded over the ``tp`` axis), so this one
        host-side bookkeeper serves every shard and refcounts, the radix
        prefix cache, CoW and trim run unchanged per shard."""
        return {
            "max_slots": self.max_slots,
            "page_size": self.page_size,
            "num_pages": self.allocator.num_pages,
            "pages_per_slot": self.pages_per_slot,
        }

    # -- slot lifecycle ----------------------------------------------------

    def acquire_slot(self) -> Optional[int]:
        """Claim a free slot (None when all are occupied)."""
        for s in range(self.max_slots):
            if not self._active[s]:
                self._active[s] = True
                self.seq_lens[s] = 0
                return s
        return None

    def release_slot(self, slot: int) -> int:
        """Free the slot's pages and point its table back at scratch.
        Returns the number of pages released."""
        enforce(self._active[slot], f"release_slot: slot {slot} not active")
        pages = self._slot_pages[slot]
        n = len(pages)
        self.allocator.free(pages)  # drops this slot's ref; shared pages
        self._slot_pages[slot] = []  # survive under the prefix cache's ref
        self.page_tables[slot, :] = SCRATCH_PAGE
        self.seq_lens[slot] = 0
        self._active[slot] = False
        self._slot_shared[slot].clear()
        return n

    def release_all(self) -> int:
        """Release every active slot (quarantine after a poisoned decode
        iteration, or engine teardown). Returns the number of slots freed.
        The device pages are untouched — their contents are garbage once
        the tables point back at scratch, which is exactly the semantics
        recovery wants: the faulted iteration's KV writes are lost and
        every sequence re-prefills from host-side tokens."""
        slots = self.active_slots()
        for s in slots:
            self.release_slot(s)
        return len(slots)

    def ensure_capacity(self, slot: int, n_positions: int) -> bool:
        """Grow ``slot`` to cover logical positions ``[0, n_positions)``.
        All-or-nothing: returns False (state unchanged) when the pool
        cannot supply the missing pages — the engine's preempt-or-queue
        decision point."""
        enforce(self._active[slot], f"ensure_capacity: slot {slot} not active")
        enforce(
            n_positions <= self.max_context,
            f"sequence needs {n_positions} positions but the slot capacity "
            f"is {self.max_context} (pages_per_slot * page_size)")
        have = len(self._slot_pages[slot])
        need = -(-n_positions // self.page_size) - have  # ceil div
        if need <= 0:
            return True
        grant = self.allocator.alloc(need)
        if grant is None:
            return False
        for i, p in enumerate(grant):
            self.page_tables[slot, have + i] = p
        self._slot_pages[slot].extend(grant)
        return True

    def trim(self, slot: int, n_positions: int) -> int:
        """Shrink ``slot`` to exactly the pages covering positions
        ``[0, n_positions)``, freeing the surplus (speculative rollback:
        pages granted for a draft block whose tokens were rejected).
        Returns the number of pages released."""
        enforce(self._active[slot], f"trim: slot {slot} not active")
        keep = -(-n_positions // self.page_size)  # ceil div
        pages = self._slot_pages[slot]
        if keep >= len(pages):
            return 0
        surplus = pages[keep:]
        self.allocator.free(surplus)
        self._slot_pages[slot] = pages[:keep]
        self.page_tables[slot, keep:] = SCRATCH_PAGE
        self._slot_shared[slot] = {
            li for li in self._slot_shared[slot] if li < keep}
        return len(surplus)

    # -- prefix sharing ----------------------------------------------------

    def adopt_pages(self, slot: int, pages: Sequence[int]) -> None:
        """Map already-written ``pages`` (a prefix-cache hit) as the slot's
        first logical pages, taking one reference per page. The slot must
        not have grown yet — hits apply at admission, before any prefill.
        The adopted logical indices are marked shared: a write into one
        (a continuation chunk straddling the hit boundary) must
        copy-on-write through :meth:`private_copy` first."""
        enforce(self._active[slot], f"adopt_pages: slot {slot} not active")
        enforce(not self._slot_pages[slot],
                f"adopt_pages: slot {slot} already has pages")
        enforce(len(pages) <= self.pages_per_slot,
                f"adopt_pages: {len(pages)} pages exceed table width "
                f"{self.pages_per_slot}")
        self.allocator.ref(pages)
        for i, p in enumerate(pages):
            self.page_tables[slot, i] = p
        self._slot_pages[slot] = list(pages)
        self._slot_shared[slot] = set(range(len(pages)))

    def is_shared(self, slot: int, logical_index: int) -> bool:
        return logical_index in self._slot_shared[slot]

    def shared_indices(self, slot: int) -> List[int]:
        return sorted(self._slot_shared[slot])

    def private_copy(self, slot: int, logical_index: int) -> Optional[tuple]:
        """Copy-on-write bookkeeping: replace the shared page at
        ``logical_index`` with a fresh private page. Returns
        ``(src_page, dst_page)`` for the engine's device-side page copy, or
        None when the pool is exhausted (state unchanged — caller preempts
        or evicts). The old page keeps its other refs (prefix cache /
        other slots); this slot's ref is dropped."""
        enforce(self._active[slot], f"private_copy: slot {slot} not active")
        enforce(logical_index in self._slot_shared[slot],
                f"private_copy: slot {slot} logical page {logical_index} "
                "is not shared")
        grant = self.allocator.alloc(1)
        if grant is None:
            return None
        src = self._slot_pages[slot][logical_index]
        dst = grant[0]
        self.allocator.free([src])
        self._slot_pages[slot][logical_index] = dst
        self.page_tables[slot, logical_index] = dst
        self._slot_shared[slot].discard(logical_index)
        return src, dst

    # -- readout -----------------------------------------------------------

    def active_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if self._active[s]]

    def slot_page_count(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's physical page ids in logical order (a copy)."""
        return list(self._slot_pages[slot])

    @property
    def pages_in_use(self) -> int:
        return self.allocator.in_use

    @property
    def pages_free(self) -> int:
        return self.allocator.num_free

    def assert_no_leaks(self) -> None:
        """Drain invariant: no active slots and every page back in the
        free list (slot bookkeeping and allocator must agree)."""
        enforce(not any(self._active),
                f"active slots after drain: {self.active_slots()}")
        enforce(sum(len(p) for p in self._slot_pages) == 0,
                "slot page lists non-empty after drain")
        self.allocator.assert_empty()
