"""Free-list page allocation + radix prefix reuse (counterpart of
``paddle_tpu/inference/generation/paging.py``, the same classes: pure
Python over ints, with no device work).

The paged decode engine stores K/V in fixed-size pages drawn from one
device pool; THIS module is the host-side brain that decides which
pool rows belong to whom. It is deliberately pure Python over plain
ints — admission runs on the dispatcher thread between device calls,
and every decision here is O(pages touched), never O(pool).

Two cooperating structures:

- :class:`PageAllocator` — a free list over page ids ``1..num_pages``
  (page 0 is the NULL page: masked device writes land there, it is
  never allocated) with per-page refcounts. A page's refcount is the
  number of owners holding it: each seated slot referencing it, plus
  the prefix trie if the page is cached there. Pages free when the
  count hits zero. The allocator REFUSES to hand out a page that is
  still referenced (double-allocation) and refuses to mark a shared
  (refcount > 1 or trie-held) page writable — the invariants the
  randomized churn test reconciles after every step.

- :class:`RadixPrefixCache` — a token trie whose edges are full pages
  (``page_size`` tokens each): node at depth k holds the page id
  caching K/V for prompt positions ``[k*page, (k+1)*page)`` under that
  token path. Prefill consults it (:meth:`match`) so requests sharing
  a system prompt reuse the resident pages instead of recomputing
  them; admission publishes a prompt's full pages (:meth:`insert`).
  Only pages FULLY covered by the prompt are ever inserted — decode
  writes at positions >= prompt length, so trie pages are immutable by
  construction (the "copy-on-write at the divergence page" discipline:
  the first partial page is always freshly allocated, never shared).
  When the free list runs dry, LRU leaves whose pages are held ONLY by
  the trie evict back to the allocator (:meth:`evict`).

Admission is BY PAGES: a request needs ``ceil((len + max_new) / page)``
pages minus whatever prefix the trie already holds; the engine tries
``alloc``, then ``evict``, then surfaces :class:`PagesExhausted` so the
predictor can defer the request at the queue head instead of failing
it — backpressure, not an error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PagesExhausted", "PageAllocator", "RadixPrefixCache",
           "pages_for"]


class PagesExhausted(RuntimeError):
    """Typed admission backpressure: the free list (after eviction)
    cannot cover a request's predicted page count. The predictor
    defers the request until slots leave — it is NOT a caller-visible
    failure unless the deadline expires first."""

    def __init__(self, message: str, needed: int, free: int):
        super().__init__(message)
        self.needed = int(needed)
        self.free = int(free)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(page_size))


class PageAllocator:
    """Free-list allocator with refcounts over page ids 1..num_pages.

    Ownership model: ``alloc`` hands out pages at refcount 1 (the
    caller — a seated slot — is the sole owner and may write them);
    ``retain`` adds an owner (a second slot sharing a prefix page, or
    the trie caching it); ``release`` drops one owner and returns the
    page to the free list at zero. ``slot_pages`` tracks which pages
    each seated slot holds so a leave releases exactly its refs."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-issued first
        # (their pool rows are warm)
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._refs: Dict[int, int] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        # pages the trie holds a ref on (insert/evict bookkeeping —
        # the writability guard refuses these even at refcount 1)
        self._trie_pages: set = set()

    # -- core -------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` fresh pages (refcount 1, writable). Raises
        :class:`PagesExhausted` without allocating anything when the
        free list is short — admission is all-or-nothing."""
        if n > len(self._free):
            raise PagesExhausted(
                f"free list has {len(self._free)} of {n} pages needed "
                f"(pool {self.num_pages} pages x {self.page_size} "
                f"tokens)", n, len(self._free))
        out = []
        for _ in range(int(n)):
            p = self._free.pop()
            if self._refs.get(p, 0) != 0:
                raise AssertionError(
                    f"free-list corruption: page {p} on the free list "
                    f"with refcount {self._refs[p]}")
            self._refs[p] = 1
            out.append(p)
        return out

    def retain(self, pages: Sequence[int]):
        """Add one owner to each page (must be live)."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise AssertionError(
                    f"retain of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]):
        """Drop one owner from each page; zero-ref pages return to the
        free list."""
        for p in pages:
            c = self._refs.get(p, 0)
            if c <= 0:
                raise AssertionError(
                    f"release of unallocated page {p}")
            if c == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = c - 1

    def writable(self, page: int) -> bool:
        """May a slot WRITE this page? Only a sole owner outside the
        trie — a refcounted prefix page is immutable (other slots and
        future prefill hits read it)."""
        return (self._refs.get(page, 0) == 1
                and page not in self._trie_pages)

    def assert_writable(self, pages: Sequence[int]):
        for p in pages:
            if not self.writable(p):
                raise AssertionError(
                    f"page {p} is shared (refcount {self.refcount(p)}"
                    f"{', trie-held' if p in self._trie_pages else ''})"
                    f" — handing it out for writing would corrupt "
                    f"another request's tokens")

    # -- slot ownership ---------------------------------------------------
    def seat_slot(self, slot: int, pages: Sequence[int]):
        """Record ``slot`` as holding ``pages`` (refs already taken by
        alloc/retain). A slot seated twice must have been released
        first."""
        if slot in self._slot_pages:
            raise AssertionError(f"slot {slot} already seated")
        self._slot_pages[slot] = list(pages)

    def release_slot(self, slot: int) -> int:
        """Drop the slot's refs; returns how many pages actually hit
        the free list (shared prefix pages may stay resident under the
        trie's ref)."""
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            return 0
        before = len(self._free)
        self.release(pages)
        return len(self._free) - before

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, ()))

    # -- invariants (the property test reconciles after every step) ------
    def check(self):
        """Free list + refcounted pages partition 1..num_pages exactly;
        no page is both free and referenced; every slot/trie ref is
        accounted. Raises AssertionError on any violation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        live = set(self._refs)
        if free & live:
            raise AssertionError(
                f"pages both free and referenced: {sorted(free & live)}")
        if free | live != set(range(1, self.num_pages + 1)):
            raise AssertionError(
                f"page leak: {self.num_pages - len(free) - len(live)} "
                f"pages neither free nor referenced")
        if any(c <= 0 for c in self._refs.values()):
            raise AssertionError("zero/negative refcount retained")
        # refcounts reconcile: each page's owners = seated slots
        # holding it + 1 if the trie caches it
        owners: Dict[int, int] = {}
        for pages in self._slot_pages.values():
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        for p in self._trie_pages:
            owners[p] = owners.get(p, 0) + 1
        if owners != self._refs:
            diff = {p: (owners.get(p, 0), self._refs.get(p, 0))
                    for p in set(owners) | set(self._refs)
                    if owners.get(p, 0) != self._refs.get(p, 0)}
            raise AssertionError(
                f"refcounts do not reconcile (page: owners vs refs): "
                f"{diff}")


class _TrieNode:
    __slots__ = ("children", "page", "touch", "owner")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page: int = 0
        self.touch: int = 0
        # who published this page (the inserting request's trace id) —
        # prefix-hit traces name the ancestor they are riding on
        self.owner: Optional[str] = None


class RadixPrefixCache:
    """Token trie of immutable shared prompt pages, LRU-evicted.

    Edges are full pages — ``page_size``-token tuples — so matching is
    page-granular by construction: a hit reuses whole resident pages
    and the divergence page is always freshly written (structural
    copy-on-write). The cache holds ONE allocator ref per cached page;
    eviction drops it, freeing the page iff no seated slot still
    shares it."""

    def __init__(self, alloc: PageAllocator):
        self._alloc = alloc
        self._root = _TrieNode()
        self._clock = 0
        self._pages = 0

    @property
    def page_size(self) -> int:
        return self._alloc.page_size

    @property
    def cached_pages(self) -> int:
        return self._pages

    def cached_bytes(self, page_nbytes: int) -> int:
        return self._pages * int(page_nbytes)

    # -- lookup -----------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None) -> List[int]:
        """Longest cached page-path along ``tokens``; returns the page
        ids (depth order). ``max_tokens`` caps the match (the engine
        passes ``len(prompt) - 1`` so at least one prompt token always
        runs through prefill — decode needs its logits). Touches the
        matched path for LRU."""
        return self.match_info(tokens, max_tokens)[0]

    def match_info(self, tokens: Sequence[int],
                   max_tokens: Optional[int] = None
                   ) -> Tuple[List[int], Optional[str]]:
        """:meth:`match` plus attribution: also returns the owner tag
        of the DEEPEST matched node — the trace id of the request that
        published the pages this hit is riding on (None on a miss or
        for pages published without tracing)."""
        p = self.page_size
        limit = len(tokens) if max_tokens is None \
            else min(len(tokens), int(max_tokens))
        self._clock += 1
        node, out, owner = self._root, [], None
        for k in range(limit // p):
            edge = tuple(int(t) for t in tokens[k * p:(k + 1) * p])
            nxt = node.children.get(edge)
            if nxt is None:
                break
            nxt.touch = self._clock
            out.append(nxt.page)
            if nxt.owner is not None:
                owner = nxt.owner
            node = nxt
        return out, owner

    # -- publish ----------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               owner: Optional[str] = None) -> int:
        """Cache ``pages`` (page k covers tokens [k*p, (k+1)*p)) under
        the token path, taking one allocator ref per NEWLY cached page.
        Pages already on the path are left as-is (the caller matched
        them from here in the first place). ``owner`` tags the newly
        cached nodes with the publishing request's trace id so later
        hits can attribute their reuse. Returns how many pages were
        newly cached."""
        p = self.page_size
        if len(tokens) < len(pages) * p:
            raise ValueError(
                f"{len(pages)} pages need {len(pages) * p} tokens, "
                f"got {len(tokens)}")
        self._clock += 1
        node, added = self._root, 0
        for k, page in enumerate(pages):
            edge = tuple(int(t) for t in tokens[k * p:(k + 1) * p])
            nxt = node.children.get(edge)
            if nxt is None:
                if not self._alloc.writable(page) \
                        and self._alloc.refcount(page) == 1:
                    # already trie-held under another path — one page
                    # cannot cache two different token paths
                    raise AssertionError(
                        f"page {page} already cached in the trie")
                nxt = _TrieNode()
                nxt.page = int(page)
                nxt.owner = owner
                node.children[edge] = nxt
                self._alloc.retain([page])
                self._alloc._trie_pages.add(int(page))
                self._pages += 1
                added += 1
            nxt.touch = self._clock
            node = nxt
        return added

    # -- eviction ---------------------------------------------------------
    def evict(self, want_free: int) -> int:
        """LRU-evict leaf pages held ONLY by the trie until
        ``want_free`` pages have actually returned to the free list
        (or nothing evictable remains). Returns pages freed. Interior
        nodes become leaves as their children go — eviction walks
        bottom-up by construction."""
        freed = 0
        while freed < want_free:
            victim = self._lru_evictable_leaf()
            if victim is None:
                break
            parent, edge, node = victim
            del parent.children[edge]
            self._alloc._trie_pages.discard(node.page)
            before = self._alloc.free_count
            self._alloc.release([node.page])
            freed += self._alloc.free_count - before
            self._pages -= 1
        return freed

    def _lru_evictable_leaf(self):
        """(parent, edge, node) of the least-recently-touched leaf
        whose page would actually free (refcount 1 = trie only)."""
        best = None
        stack = [(self._root, None, None)]
        while stack:
            node, parent, edge = stack.pop()
            if parent is not None and not node.children \
                    and self._alloc.refcount(node.page) == 1:
                if best is None or node.touch < best[2].touch:
                    best = (parent, edge, node)
            for e, child in node.children.items():
                stack.append((child, node, e))
        return best

    def check(self):
        """Every cached page is allocator-live and trie-tagged; the
        page count matches the node count."""
        count, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                count += 1
                if self._alloc.refcount(child.page) < 1:
                    raise AssertionError(
                        f"trie page {child.page} is not allocated")
                if child.page not in self._alloc._trie_pages:
                    raise AssertionError(
                        f"trie page {child.page} missing the trie tag")
                stack.append(child)
        if count != self._pages:
            raise AssertionError(
                f"trie page count drifted: {count} nodes vs "
                f"{self._pages} counted")
        if len(self._alloc._trie_pages) != count:
            raise AssertionError(
                f"allocator trie-tag set ({len(self._alloc._trie_pages)}"
                f") != trie nodes ({count})")
