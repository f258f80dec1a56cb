"""Fixed-size block-pool KV allocator for the paged serve path (a copy of
``repro/core/kv_pages.py``: the port imports nothing of the reference).

A request's KV occupancy is a *page table* (an ordered list of page
indices) into device pools of fixed-size pages; freeing is O(pages) list
surgery, and a freed page is reusable immediately because the device-side
position buffer (``ppos``) is reset to -1 at the next admission (stale
positions would otherwise unmask a prior tenant's keys).

This module is pure host-side bookkeeping: the device pools and the
programs that read them live in ``models/transformer.py`` /
``kernels/attn_flash.py``; the continuous-batching scheduler that drives
both is ``launch/engine.ContinuousLMEngine``.

Reserved index: ``null_page == num_pages`` — one extra, never-allocated
page at the end of the device pools whose ``ppos`` stays -1 forever.  Table
rows pad to a fixed width with it, so gathering a padded row always lands
on masked slots.  Device-side writes never target it (only the valid rows
of a step are written).
"""
from __future__ import annotations

from collections import deque


class PoolExhausted(RuntimeError):
    """No free pages: admission control must defer (or shed) the request."""


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages covering ``total_tokens`` KV positions (ragged final page)."""
    if total_tokens <= 0:
        return 0
    return -(-total_tokens // page_size)


class PagePool:
    """Free-list allocator over ``num_pages`` fixed-size KV pages.

    FIFO reuse (freed pages re-allocate in release order) keeps the
    allocation sequence a pure function of the request schedule — the
    deterministic-replay property the resilience checkpoints rely on.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need at least one page and one slot per page, "
                             f"got num_pages={num_pages}, page_size={page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.null_page = num_pages          # reserved: masked padding target
        self._free: deque[int] = deque(range(num_pages))
        self._owned: set[int] = set()
        # capacity accounting
        self.allocs = 0
        self.frees = 0
        self.high_water = 0

    # -- capacity -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_fit(self, total_tokens: int) -> bool:
        """Could ``total_tokens`` of KV be admitted right now?"""
        return pages_needed(total_tokens, self.page_size) <= self.free_pages

    def capacity_tokens(self) -> int:
        """Upper bound on one request's KV extent (the whole pool)."""
        return self.num_pages * self.page_size

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages; raises :class:`PoolExhausted` (allocating
        nothing) when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PoolExhausted(
                f"{n} page(s) requested, {len(self._free)} free "
                f"(pool: {self.num_pages} x {self.page_size} tokens)")
        pages = [self._free.popleft() for _ in range(n)]
        self._owned.update(pages)
        self.allocs += n
        self.high_water = max(self.high_water, self.used_pages)
        return pages

    def free(self, pages) -> None:
        """Return pages to the pool.  Double-free and foreign indices are
        programming errors (they would alias two requests' KV) — raise."""
        for p in pages:
            if p not in self._owned:
                raise ValueError(f"page {p} is not currently allocated "
                                 "(double free, or foreign index)")
        for p in pages:
            self._owned.discard(p)
            self._free.append(p)
            self.frees += 1

    def stats(self) -> dict:
        return dict(num_pages=self.num_pages, page_size=self.page_size,
                    used_pages=self.used_pages, free_pages=self.free_pages,
                    high_water=self.high_water, allocs=self.allocs,
                    frees=self.frees)

    # -- checkpointing --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable allocator state.  The free list is saved *in
        order*: FIFO reuse order is part of the deterministic-replay
        contract, so a restored pool must hand out the same pages the
        original would have."""
        return dict(num_pages=self.num_pages, page_size=self.page_size,
                    free=list(self._free), owned=sorted(self._owned),
                    allocs=self.allocs, frees=self.frees,
                    high_water=self.high_water)

    def restore(self, snap: dict) -> None:
        """Overwrite this pool's state with a :meth:`snapshot`.  Geometry
        must match — a checkpoint from a differently-sized pool would alias
        page indices."""
        if (snap["num_pages"] != self.num_pages
                or snap["page_size"] != self.page_size):
            raise ValueError(
                f"pool geometry mismatch: snapshot is "
                f"{snap['num_pages']}x{snap['page_size']}, pool is "
                f"{self.num_pages}x{self.page_size}")
        self._free = deque(int(p) for p in snap["free"])
        self._owned = {int(p) for p in snap["owned"]}
        self.allocs = int(snap["allocs"])
        self.frees = int(snap["frees"])
        self.high_water = int(snap["high_water"])
