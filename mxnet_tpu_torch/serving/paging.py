"""Host-side bookkeeping for the paged KV cache: the page allocator
and the shared-prefix index.

Counterpart of ``mxnet_tpu/serving/paging.py``, ported as it is: it is
plain Python over page ids, with the port's own ``telemetry`` and
``tracing``. The DEVICE side of paging lives in
``gluon/model_zoo/gpt.py`` (``init_paged_cache`` and the paged
prefill/decode/peek/bind/copy calls, which update the pool in place)
and ``ops/attention.py`` (``paged_decode_attention``, K3 on the card).
This module owns which physical page belongs to whom:

- :class:`PagePool` — a free list plus per-page refcounts over the
  ``n_pages`` physical pages of one engine's pool. Page 0 is the
  reserved SCRAP page (free table entries point at it; redirected
  writes land in it) and is never handed out. A page is writable by a
  slot only while its refcount is exactly 1 — a refcount above 1 means
  the page is shared (other slots and/or the prefix index hold it) and
  a writer must copy first (COW).
- :class:`PrefixIndex` — maps prompt-token BLOCKS (one block = one
  page) to the immutable pages that already hold their K/V. Two
  structures: a block-hash *chain* (vLLM-style: block ``i``'s key
  folds block ``i-1``'s key, so a chain hit is a shared *prefix*, not
  a coincidence of content) resolving any number of leading full
  pages, and a *full-prompt* digest table resolving an entire prompt —
  including a partial final page — to its page row, which is what lets
  an identical request skip prefill completely (the engine ``peek``s
  its first token off the cached K/V). Registered pages are retained
  (refcount +1) by the index so prefixes survive their original
  request; records are LRU-evicted when the engine needs pages back.

Thread-safety: both classes are engine-internal and only touched under
the engine's ``_gen_lock`` (admission/step boundaries); they do no
locking of their own.

Telemetry: counters
``serving.generate.pages.{allocated,shared,cow_copies,freed}``, gauge
``serving.generate.pages.free``.
"""
from __future__ import annotations

import collections
import hashlib

from .. import telemetry, tracing

__all__ = ["PagePool", "PrefixIndex"]

#: physical page 0 — scrap target for redirected writes, never allocated
SCRAP_PAGE = 0


class PagePool:
    """Free list + refcounts over one engine's physical KV pages."""

    def __init__(self, n_pages: int):
        if int(n_pages) < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is "
                             "the reserved scrap page)")
        self.n_pages = int(n_pages)
        # LIFO free list: recently-freed pages are re-used first (their
        # pool rows are the likeliest still resident in cache/HBM)
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._refs = {}
        self._gauge()

    def _gauge(self):
        telemetry.gauge("serving.generate.pages.free", len(self._free))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def alloc(self, n: int):
        """Allocate ``n`` pages (refcount 1 each) or None if the pool
        cannot cover them — the caller decides whether to evict cached
        prefixes and retry or to defer admission."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._refs[pid] = 1
        telemetry.counter("serving.generate.pages.allocated", n)
        self._gauge()
        return out

    def retain(self, pid: int):
        """Add one reference to an allocated page (a new slot or the
        prefix index sharing it)."""
        if pid == SCRAP_PAGE:
            raise ValueError("scrap page 0 cannot be retained")
        if pid not in self._refs:
            raise ValueError(f"retain of unallocated page {pid}")
        self._refs[pid] += 1
        telemetry.counter("serving.generate.pages.shared")

    def release(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed
        back to the pool."""
        n = self._refs.get(pid)
        if n is None:
            raise ValueError(f"release of unallocated page {pid}")
        if n > 1:
            self._refs[pid] = n - 1
            return False
        del self._refs[pid]
        self._free.append(pid)
        telemetry.counter("serving.generate.pages.freed")
        self._gauge()
        return True


class _Record:
    """One registered prompt: the chain entries its pages BACK (an
    entry resolving a block to a different record's physical page is
    not listed — this record is not keeping it alive), every page it
    retains (full blocks + partial tail), and its length."""

    __slots__ = ("keys", "pages", "length")

    def __init__(self, keys, pages, length):
        self.keys = keys
        self.pages = pages
        self.length = length


class PrefixIndex:
    """Block-hash chain + full-prompt digest over immutable KV pages."""

    def __init__(self, pool: PagePool, page_size: int,
                 max_records: int = 128):
        self._pool = pool
        self._ps = int(page_size)
        self.max_records = int(max_records)
        #: (parent_key, block_digest) -> [child_key, page_id, users]
        self._chain: dict = {}
        #: prompt digest -> _Record, in LRU order (oldest first)
        self._records: "collections.OrderedDict[bytes, _Record]" = \
            collections.OrderedDict()

    def __len__(self):
        return len(self._records)

    @staticmethod
    def _digest(parent: bytes, block_bytes: bytes) -> bytes:
        return hashlib.blake2b(parent + block_bytes,
                               digest_size=16).digest()

    def _blocks(self, prompt):
        """Chain keys of the prompt's FULL blocks: [(parent, digest)]
        with the running parent key folded in."""
        ps = self._ps
        key = b"root"
        out = []
        for i in range(len(prompt) // ps):
            d = self._digest(key, prompt[i * ps:(i + 1) * ps].tobytes())
            out.append((key, d))
            key = d
        return out

    def match(self, prompt):
        """Longest cached prefix of ``prompt``: returns ``(pages,
        n_tokens)`` — the physical pages already holding the K/V of the
        first ``n_tokens`` tokens (NOT yet retained: the caller retains
        them per consumer). A full-prompt digest hit resolves the
        entire prompt including a partial final page; otherwise the
        block chain resolves leading full pages."""
        full = hashlib.blake2b(prompt.tobytes(), digest_size=16).digest()
        rec = self._records.get(full)
        if rec is not None and rec.length == len(prompt):
            self._records.move_to_end(full)
            return list(rec.pages), rec.length
        pages = []
        for key in self._blocks(prompt):
            e = self._chain.get(key)
            if e is None:
                break
            pages.append(e[1])
        return pages, len(pages) * self._ps

    def register(self, prompt, page_row):
        """Publish a freshly-prefilled prompt's pages as shareable:
        retain every page covering the prompt (full blocks from
        ``page_row`` plus the partial tail page, which from here on is
        immutable — the owning slot COWs before its first decode
        write), create/refcount the chain entries, and record the
        full-prompt digest. Idempotent per prompt digest. Evicts the
        LRU record past ``max_records``."""
        full = hashlib.blake2b(prompt.tobytes(), digest_size=16).digest()
        if full in self._records:
            self._records.move_to_end(full)
            return False
        ps = self._ps
        n_pages = (len(prompt) + ps - 1) // ps
        pages = [int(page_row[i]) for i in range(n_pages)]
        used_keys = []
        for key, pid in zip(self._blocks(prompt), pages):
            e = self._chain.get(key)
            if e is None:
                self._chain[key] = [key[1], pid, 1]
                used_keys.append(key)
            elif e[1] == pid:
                e[2] += 1
                used_keys.append(key)
            # else: the chain already resolves this block to a DIFFERENT
            # physical page (two same-prefix prompts raced registration,
            # each prefilled privately). This record's copy stays
            # unpublished for the block — counting it as a user of the
            # other page's entry would keep that entry alive past its
            # backing record's eviction and let match() hand out a page
            # the pool has already freed.
        for pid in pages:
            self._pool.retain(pid)
        self._records[full] = _Record(used_keys, pages, len(prompt))
        while len(self._records) > self.max_records:
            self.evict_lru()
        return True

    def evict_lru(self) -> bool:
        """Drop the least-recently-used record: release its page
        references (pages free once no active slot holds them) and
        retire chain entries nobody else references. Returns False on
        an empty index."""
        if not self._records:
            return False
        _full, rec = self._records.popitem(last=False)
        tracing.flight.record("paging.prefix_evict",
                              pages=len(rec.pages), tokens=rec.length)
        for key in rec.keys:
            e = self._chain.get(key)
            if e is not None:
                e[2] -= 1
                if e[2] <= 0:
                    del self._chain[key]
        for pid in rec.pages:
            self._pool.release(pid)
        return True

    def release_all(self):
        """Drop every record (engine close)."""
        while self.evict_lru():
            pass
