"""The port's page pool and prefix index (mxnet_tpu_torch.serving.paging)
against the JAX package's: the same operation sequences — the cases of
tests/test_paged.py — run through both classes and give the same
results, refcounts and free counts at every step."""
import numpy as onp
import pytest

from mxnet_tpu.serving import paging as jpaging
from mxnet_tpu_torch.serving import paging as tpaging

VOCAB = 97
IMPLS = [jpaging, tpaging]


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _both(fn):
    """Run ``fn(paging_module)`` for both packages; the transcripts it
    returns must be equal."""
    ref, port = (fn(m) for m in IMPLS)
    assert port == ref
    return port


def test_page_pool_refcounts_and_accounting():
    def run(m):
        out = []
        pool = m.PagePool(8)           # pages 1..7 allocatable
        out.append(pool.free_count)
        a = pool.alloc(3)
        out += [a, pool.free_count, pool.alloc(5), pool.free_count]
        pool.retain(a[0])
        out += [pool.refcount(a[0]), pool.release(a[0]),
                pool.release(a[0]), pool.free_count]
        with pytest.raises(ValueError, match="unallocated"):
            pool.release(a[0])
        with pytest.raises(ValueError, match="scrap"):
            pool.retain(0)
        with pytest.raises(ValueError, match="unallocated"):
            pool.retain(7)
        with pytest.raises(ValueError, match=">= 2"):
            m.PagePool(1)
        # LIFO reuse: the page freed last comes back first
        out.append(pool.alloc(1))
        return out
    t = _both(run)
    assert t[0] == 7 and t[3] is None and t[6] is False and t[7] is True


def test_prefix_index_match_register_evict():
    def run(m):
        out = []
        pool = m.PagePool(32)
        idx = m.PrefixIndex(pool, page_size=4, max_records=8)
        rng = onp.random.RandomState(0)
        prompt = _prompt(rng, 10)             # 2 full blocks + partial
        pages = pool.alloc(3)
        row = onp.zeros(8, "i4")
        row[:3] = pages
        out += [idx.match(prompt), idx.register(prompt, row),
                idx.register(prompt, row),
                [pool.refcount(p) for p in pages], idx.match(prompt)]
        longer = onp.concatenate([prompt[:8], _prompt(rng, 6)])
        diverged = prompt.copy()
        diverged[5] = (diverged[5] + 1) % VOCAB
        out += [idx.match(longer), idx.match(diverged), idx.evict_lru(),
                [pool.refcount(p) for p in pages], idx.match(prompt),
                idx.evict_lru(), len(idx)]
        return out
    t = _both(run)
    assert t[0] == ([], 0) and t[4][1] == 10 and t[5][1] == 8 \
        and t[6][1] == 4


def test_prefix_index_registration_race_keeps_chain_consistent():
    def run(m):
        out = []
        pool = m.PagePool(32)
        idx = m.PrefixIndex(pool, page_size=4, max_records=8)
        rng = onp.random.RandomState(2)
        prompt = _prompt(rng, 8)
        other = onp.concatenate([prompt, _prompt(rng, 4)])
        p1 = pool.alloc(2)
        row1 = onp.zeros(8, "i4")
        row1[:2] = p1
        p2 = pool.alloc(3)
        row2 = onp.zeros(8, "i4")
        row2[:3] = p2
        out += [idx.register(prompt, row1), idx.register(other, row2),
                idx.evict_lru(), [pool.refcount(p) for p in p1]]
        pages, n = idx.match(onp.concatenate([prompt, _prompt(rng, 2)]))
        out += [pages, n, [pool.refcount(p) for p in pages],
                any(p in p1 for p in pages), idx.match(other)]
        return out
    t = _both(run)
    assert t[3] == [1, 1] and t[7] is False and t[8][1] == 12


def test_prefix_index_lru_bound_and_release_all():
    def run(m):
        out = []
        pool = m.PagePool(64)
        idx = m.PrefixIndex(pool, page_size=4, max_records=2)
        rng = onp.random.RandomState(1)
        rows = []
        for _ in range(3):
            p = _prompt(rng, 8)
            pages = pool.alloc(2)
            row = onp.zeros(8, "i4")
            row[:2] = pages
            out.append(idx.register(p, row))
            rows.append((p, pages))
        out += [len(idx), idx.match(rows[0][0]), idx.match(rows[2][0]),
                pool.free_count]
        idx.release_all()
        out += [len(idx), pool.free_count,
                [pool.refcount(p) for _, pgs in rows for p in pgs]]
        return out
    t = _both(run)
    assert t[3] == 2 and t[4] == ([], 0) and t[5][1] == 8
