"""The page allocator and the radix prefix trie of the port against the
JAX package's: every allocator and trie case of
tests/test_generation_paging.py run on both packages' classes (the port
keeps its own copy of ``paging.py``), and the randomized churn run on the
two side by side, their free lists and trie sizes equal after every
step."""

import numpy as np
import pytest

from paddle_tpu.inference.generation import paging as jpaging

from paddle_tpu_torch.inference.generation import paging as ppaging


@pytest.fixture(params=["jax", "port"])
def m(request):
    return {"jax": jpaging, "port": ppaging}[request.param]


def test_pages_for(m):
    assert m.pages_for(0, 8) == 0
    assert m.pages_for(-3, 8) == 0
    assert m.pages_for(1, 8) == 1
    assert m.pages_for(8, 8) == 1
    assert m.pages_for(9, 8) == 2
    assert m.pages_for(24, 8) == 3
    assert m.pages_for(25, 8) == 4


def test_alloc_all_or_nothing(m):
    a = m.PageAllocator(4, 8)
    got = a.alloc(3)
    assert len(got) == 3 and len(set(got)) == 3
    a.seat_slot(0, got)  # check() reconciles refs against owners
    assert a.free_count == 1
    with pytest.raises(m.PagesExhausted) as ei:
        a.alloc(2)
    # nothing was allocated by the failed call
    assert ei.value.needed == 2 and ei.value.free == 1
    assert a.free_count == 1
    a.check()
    assert a.release_slot(0) == 3
    assert a.free_count == 4
    a.check()


def test_writable_guard_and_double_seat(m):
    a = m.PageAllocator(4, 8)
    p1, p2 = a.alloc(2)
    assert a.writable(p1)
    a.retain([p1])  # second owner (another slot)
    assert not a.writable(p1)
    with pytest.raises(AssertionError):
        a.assert_writable([p1])
    a.release([p1])
    assert a.writable(p1)
    a.seat_slot(0, [p1, p2])
    with pytest.raises(AssertionError):
        a.seat_slot(0, [p2])  # must release before re-seating
    assert a.release_slot(0) == 2
    assert a.release_slot(0) == 0  # idempotent
    a.check()


def test_release_of_free_page_refused(m):
    a = m.PageAllocator(2, 8)
    (p,) = a.alloc(1)
    a.release([p])
    with pytest.raises(AssertionError):
        a.release([p])
    with pytest.raises(AssertionError):
        a.retain([p])


# ---------------------------------------------------------------------------
# radix prefix cache semantics
# ---------------------------------------------------------------------------

def test_trie_match_insert_and_cap(m):
    a = m.PageAllocator(8, 4)
    pc = m.RadixPrefixCache(a)
    toks = list(range(100, 112))  # 3 full pages of 4
    pages = a.alloc(3)
    a.seat_slot(0, pages)
    assert pc.insert(toks, pages) == 3
    assert pc.cached_pages == 3
    assert pc.match(toks) == pages
    # match is capped: len-1 keeps >= 1 token for prefill
    assert pc.match(toks, max_tokens=len(toks) - 1) == pages[:2]
    assert pc.match(toks, max_tokens=3) == []
    # divergent tail shares only the common prefix path
    other = toks[:4] + [7, 7, 7, 7]
    assert pc.match(other) == pages[:1]
    # re-inserting the same path adds nothing (and takes no new refs)
    assert pc.insert(toks, pages) == 0
    pc.check()
    a.check()
    # the seated slot leaves; pages stay resident under the trie alone
    a.release_slot(0)
    assert a.free_count == a.num_pages - 3
    a.check()


def test_trie_evict_lru_and_seated_pages_survive(m):
    a = m.PageAllocator(8, 4)
    pc = m.RadixPrefixCache(a)
    cold = a.alloc(1)
    warm = a.alloc(1)
    pc.insert([1, 2, 3, 4], cold)
    pc.insert([9, 8, 7, 6], warm)
    pc.match([9, 8, 7, 6])  # touch: warm becomes most-recent
    # a seated slot shares the warm page: eviction must not free it
    a.retain(warm)
    a.seat_slot(0, warm)
    a.release(cold)  # drop the alloc ref; trie ref remains
    a.release(warm)
    freed = pc.evict(2)
    assert freed == 1  # only the cold page could free
    assert pc.cached_pages == 1
    assert a.refcount(warm[0]) >= 1  # still seated
    a.check()
    pc.check()
    # after the slot leaves, the warm page becomes evictable
    a.release_slot(0)
    assert pc.evict(1) == 1
    assert a.free_count == a.num_pages
    a.check()
    pc.check()


def test_trie_owner_attribution_match_info(m):
    """match_info names which request published the matched pages: the
    deepest matched node's owner tag, so a hit can point at its
    ancestor."""
    a = m.PageAllocator(8, 4)
    pc = m.RadixPrefixCache(a)
    toks = list(range(100, 112))  # 3 full pages of 4
    pages = a.alloc(3)
    a.seat_slot(0, pages)
    assert pc.insert(toks, pages, owner="t00000007") == 3
    got, owner = pc.match_info(toks)
    assert got == pages and owner == "t00000007"
    # a shorter hit still resolves to the publisher of its deepest node
    got, owner = pc.match_info(toks[:4] + [7, 7, 7, 7])
    assert got == pages[:1] and owner == "t00000007"
    # no match, no owner
    assert pc.match_info([55, 66, 77, 88]) == ([], None)
    # a second publisher extends the path; the deeper owner wins for
    # deep matches while the shallow prefix keeps the original
    ext = toks + [1, 2, 3, 4]
    more = a.alloc(1)
    a.seat_slot(1, more)
    pc.insert(ext, pages + more, owner="t00000009")
    got, owner = pc.match_info(ext)
    assert got == pages + more and owner == "t00000009"
    got, owner = pc.match_info(toks)
    assert got == pages and owner == "t00000007"
    # owner-less inserts (monitor off) still match, owner stays None
    solo = a.alloc(1)
    a.seat_slot(2, solo)
    pc.insert([41, 42, 43, 44], solo)
    assert pc.match_info([41, 42, 43, 44]) == (solo, None)
    # match() keeps its original contract — pages only
    assert pc.match(toks) == pages
    pc.check()
    a.check()


def test_trie_rejects_cross_path_page_reuse(m):
    a = m.PageAllocator(4, 4)
    pc = m.RadixPrefixCache(a)
    page = a.alloc(1)
    pc.insert([1, 2, 3, 4], page)
    a.release(page)  # admit ref dropped: trie is the sole owner
    with pytest.raises(AssertionError):
        pc.insert([5, 6, 7, 8], page)  # one page, two token paths


def test_allocator_trie_randomized_churn(m):
    """Randomized alloc/seat/insert/match/evict/release churn with the
    full invariant reconciliation after EVERY step — the free list and
    refcounts must partition the pool exactly, trie tags must match
    trie nodes, no page may leak or double-free."""
    rng = np.random.RandomState(1234)
    a = m.PageAllocator(12, 4)
    pc = m.RadixPrefixCache(a)
    seated = {}  # slot -> pages
    next_slot = 0
    for step in range(400):
        op = rng.randint(0, 5)
        try:
            if op == 0:  # admit: alloc + maybe share a trie match
                toks = [int(t) for t in rng.randint(0, 3, (8,))]
                shared = pc.match(toks, max_tokens=7)
                a.retain(shared)
                try:
                    fresh = a.alloc(rng.randint(1, 3))
                except m.PagesExhausted:
                    a.release(shared)
                    pc.evict(2)
                    continue
                slot = next_slot
                next_slot += 1
                a.seat_slot(slot, shared + fresh)
                seated[slot] = (toks, shared + fresh)
            elif op == 1 and seated:  # leave
                slot = list(seated)[rng.randint(0, len(seated))]
                del seated[slot]
                a.release_slot(slot)
            elif op == 2 and seated:  # publish full pages to the trie
                slot = list(seated)[rng.randint(0, len(seated))]
                toks, pages = seated[slot]
                n_full = min(len(pages), len(toks) // pc.page_size)
                pc.insert(toks[:n_full * pc.page_size],
                          pages[:n_full])
            elif op == 3:  # pressure: evict
                pc.evict(rng.randint(1, 4))
            else:  # lookup only
                toks = [int(t) for t in rng.randint(0, 3, (8,))]
                pc.match(toks)
        finally:
            a.check()
            pc.check()
    # drain: every slot leaves, the whole trie evicts, pool is whole
    for slot in list(seated):
        a.release_slot(slot)
    pc.evict(a.num_pages)
    assert pc.cached_pages == 0
    assert a.free_count == a.num_pages
    a.check()
    pc.check()


def test_churn_same_decisions_in_both_packages():
    """The churn above, driven by one random sequence through both
    packages at once: the same pages out of every alloc, the same
    matches, the same evictions."""
    rng = np.random.RandomState(99)
    both = [(mod.PageAllocator(10, 4), mod) for mod in (jpaging, ppaging)]
    both = [(a, mod.RadixPrefixCache(a), mod) for a, mod in both]
    seated = {}
    for step in range(300):
        op = rng.randint(0, 4)
        toks = [int(t) for t in rng.randint(0, 3, (8,))]
        n = rng.randint(1, 3)
        got = []
        for a, pc, mod in both:
            if op == 0:
                shared = pc.match(toks, max_tokens=7)
                a.retain(shared)
                try:
                    fresh = a.alloc(n)
                except mod.PagesExhausted:
                    a.release(shared)
                    got.append(("exhausted", pc.evict(2)))
                    continue
                a.seat_slot(step, shared + fresh)
                seated.setdefault(step, []).append((toks, shared + fresh))
                got.append((shared, fresh))
            elif op == 1 and seated:
                slot = sorted(seated)[step % len(seated)]
                got.append(a.release_slot(slot))
            elif op == 2 and seated:
                slot = sorted(seated)[step % len(seated)]
                t, pages = seated[slot][0]
                n_full = min(len(pages), len(t) // pc.page_size)
                got.append(pc.insert(t[:n_full * pc.page_size],
                                     pages[:n_full]))
            else:
                got.append(pc.evict(n))
            got.append((a.free_count, pc.cached_pages))
            a.check()
            pc.check()
        if op == 1 and seated:
            del seated[sorted(seated)[step % len(seated)]]
        assert got[:len(got) // 2] == got[len(got) // 2:], step
