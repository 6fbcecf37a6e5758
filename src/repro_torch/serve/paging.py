"""Host-side page-pool bookkeeping for the paged KV cache contract
(counterpart of ``repro/serve/paging.py``, ported whole).

Pure Python, free of any array library (like scheduler.py): the
free-list allocator, per-page refcounts, the reservation ledger that
makes lazy page growth deadlock-free, and the chained prefix registry
that backs prefix caching.

Physical page 0 is the reserved *trash* page: dead or not-yet-allocated
logical pages map there, so on-device decode can keep writing through
the page table for every row without host-side masking — trash contents
are never attended to (k_pos == -1 for unallocated slots, and live rows
never map real positions to page 0).

Prefix registry: a cached prompt prefix is a *chain* of pages keyed by
the exact leading token blocks — key for page j is
tuple(tokens[: (j+1) * page_size]) — so a lookup walks the chain until
the first miss, and two prompts share pages exactly as far as their
token-level common prefix extends (whole pages only). Pages whose
refcount drops to zero park in an LRU "cached" pool instead of the free
list; the allocator evicts them (oldest first, unregistering their
chain key) only when the free list runs dry.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class SlotPages:
    """Host-side page accounting for one occupied slot: the physical
    pages backing its logical ring (shared prefix first), how many of
    them are shared (refcounted, never written by this slot), and the
    worst-case page count reserved at admission.

    Chunked-prefill engines additionally track the slot's prefill
    cursor: `prefill_pos` is the next prompt token offset to compute
    (starts past any prefix-cache hit), `prefill_done` flips when the
    final chunk has run, and `first_chunk` tells the dispatch to reset
    the slot's k_pos row on device (the row still describes the
    previous occupant until then). One-shot admission fills the whole
    ring in a single dispatch and binds with the defaults below."""
    pages: list
    n_shared: int
    worst: int
    prefill_pos: int = 0
    prefill_done: bool = True
    first_chunk: bool = False


class PagePool:
    """Allocator + refcounts + prefix registry over ``n_pages`` physical
    pages of ``page_size`` tokens. Page 0 is the trash page and is never
    allocated."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (one trash + one "
                             f"usable page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.trash = 0
        self.free: collections.deque[int] = collections.deque(range(1, n_pages))
        self.ref: dict[int, int] = {}                 # page -> refcount (> 0)
        # ref-0 pages still holding a registered prefix, LRU order
        self.cached: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()                 # page -> chain key
        self.registry: dict[tuple, int] = {}          # chain key -> page
        self.key_of: dict[int, tuple] = {}            # page -> chain key
        self.reserved = 0                             # outstanding growth IOUs
        self.pages_peak = 0

    # -- capacity ----------------------------------------------------------

    @property
    def in_use(self) -> int:
        """Pages with refcount > 0 (excludes evictable cached pages)."""
        return len(self.ref)

    def available(self) -> int:
        """Pages allocatable right now: free + evictable cached, net of
        outstanding reservations. The admission budget."""
        return len(self.free) + len(self.cached) - self.reserved

    # -- alloc / free ------------------------------------------------------

    def _take_one(self) -> int:
        if self.free:
            return self.free.popleft()
        page, key = self.cached.popitem(last=False)   # evict LRU cached page
        del self.registry[key]
        del self.key_of[page]
        return page

    def alloc(self, n: int):
        """Allocate ``n`` fresh pages (refcount 1 each), evicting cached
        prefixes LRU-first if the free list runs dry. Returns the page
        list, or None if the pool cannot cover the request without
        eating into outstanding reservations."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if self.available() < n:
            return None
        pages = [self._take_one() for _ in range(n)]
        for p in pages:
            self.ref[p] = 1
        self.pages_peak = max(self.pages_peak, self.in_use)
        return pages

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` pages for future alloc_reserved growth.
        Reserving the worst case at admission is what makes lazy decode
        growth deadlock-free: an admitted request can always finish."""
        if n < 0:
            raise ValueError(f"reserve({n})")
        if self.available() < n:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if not 0 <= n <= self.reserved:
            raise ValueError(f"unreserve({n}) with reserved={self.reserved}")
        self.reserved -= n

    def alloc_reserved(self, n: int):
        """Convert ``n`` reservations into real pages. Cannot fail while
        the reservation invariant holds."""
        if n > self.reserved:
            raise ValueError(f"alloc_reserved({n}) > reserved={self.reserved}")
        self.reserved -= n
        pages = self.alloc(n)
        assert pages is not None, "reservation invariant violated"
        return pages

    def share(self, pages) -> None:
        """Incref ``pages`` (a prefix hit): pins cached (ref-0) pages
        back into use and bumps already-shared ones."""
        for p in pages:
            if p in self.cached:
                del self.cached[p]
                self.ref[p] = 1
            else:
                self.ref[p] += 1
        self.pages_peak = max(self.pages_peak, self.in_use)

    def release(self, pages) -> None:
        """Decref ``pages``. Refcount-0 pages holding a registered
        prefix park in the cached pool (content retained, evictable);
        unregistered ones return to the free list."""
        for p in pages:
            r = self.ref[p] - 1
            if r > 0:
                self.ref[p] = r
                continue
            del self.ref[p]
            key = self.key_of.get(p)
            if key is not None:
                self.cached[p] = key                  # parked as MRU
            else:
                self.free.append(p)

    # -- prefix registry ---------------------------------------------------

    def _chain_keys(self, tokens):
        ps = self.page_size
        for end in range(ps, len(tokens) + 1, ps):
            yield tuple(tokens[:end])

    def match(self, tokens, limit: int | None = None):
        """Longest registered page chain covering a leading page-aligned
        block of ``tokens`` (at most ``limit`` pages). Pure lookup — no
        refcount change; pair with share() before any alloc that could
        evict the chain."""
        pages = []
        for key in self._chain_keys(tokens):
            if limit is not None and len(pages) >= limit:
                break
            p = self.registry.get(key)
            if p is None:
                break
            pages.append(p)
        return pages

    def register(self, tokens, pages) -> None:
        """Record ``pages[j]`` as the cached page for tokens
        [j*ps, (j+1)*ps). Chain positions already registered (e.g. the
        shared prefix a hit was admitted against, or a duplicate prompt
        in the same batch) are left as-is — their pages keep serving."""
        for j, key in enumerate(self._chain_keys(tokens)):
            if j >= len(pages):
                break
            if key in self.registry:
                continue
            self.registry[key] = pages[j]
            self.key_of[pages[j]] = key
