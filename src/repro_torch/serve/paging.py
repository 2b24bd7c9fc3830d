"""Paged KV accounting: fixed-size pages, per-request block tables and
copy-on-write prefix sharing.

The port's host-side copy of ``repro.serve.paging.PageAllocator``. A
``PageAllocator`` owns ``num_pages`` pages and, per request, a block table:
the ordered physical page ids holding that request's KV history. Every page
carries a refcount, which the guard's pool auditor checks against the tables.

Prefix sharing: a prefix index maps token prefixes to the physical page
holding that slice of history. Admission adopts the leading full pages of a
matching resident chain by reference (``adopt_prefix``: refcount + 1, no
prefill writes), and a prompt's pages are indexed for later arrivals
(``register_prefix``). Shared pages are read-only: before appending, the
scheduler asks ``shared_pages_in`` and materializes a private copy of each
shared page it would write (``cow_page``). A page returns to the pool when its
refcount reaches 0, and the index entries naming it go at that moment.
Speculative decoding forks a request's chain (``fork_chain``: refcounts only,
no copies) and commits or aborts the fork after the chunk.

Allocation is all-or-nothing, so the scheduler can probe for pressure before
touching device state, and pop order is deterministic (lowest free page
first), so block tables are reproducible. ``grow`` is the allocator's half of
the int8 degradation rung.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dataflow


class PageAllocator:
    """Fixed-pool page allocator with per-request (rid-keyed) block tables."""

    def __init__(self, num_pages: int, page_size: int = dataflow.PAGE_SIZE):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need num_pages >= 1 and page_size >= 1, got "
                             f"{num_pages}, {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self._refs = [0] * num_pages
        # (parent physical page, this page's token slice) -> physical page;
        # the parent id pins the whole preceding prefix, -1 is the root, and
        # a partial-tail key carries the (< page_size) remainder
        self._prefix_index: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._page_keys: Dict[int, List[Tuple]] = {}

    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_of(self, rid: int) -> int:
        return len(self._tables.get(rid, ()))

    def table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def live_requests(self) -> List[int]:
        return sorted(self._tables)

    def pages_for(self, n_tokens: int) -> int:
        return dataflow.pages_for(n_tokens, self.page_size)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def snapshot(self) -> Dict:
        """Copy of the allocator's state for the pool auditor
        (``guard.audit_pool``), in the reference's layout."""
        return {
            "free": list(self._free),
            "refs": list(self._refs),
            "tables": {rid: list(t) for rid, t in self._tables.items()},
            "lengths": dict(self._lengths),
            "prefix_index": dict(self._prefix_index),
            "page_keys": {p: list(k) for p, k in self._page_keys.items()},
        }

    def fingerprint(self) -> Tuple:
        """A hashable digest of the allocation state: the free list, the
        refcounts, every block table and length (the prefix index left
        out; ``snapshot`` has it)."""
        return (tuple(self._free), tuple(self._refs),
                tuple(sorted((rid, tuple(t))
                             for rid, t in self._tables.items())),
                tuple(sorted(self._lengths.items())))

    def _pop_free(self) -> int:
        page = self._free.pop()
        if self._refs[page]:
            raise RuntimeError(f"free page {page} has refcount "
                               f"{self._refs[page]}")
        self._refs[page] = 1
        return page

    def _release(self, page: int) -> bool:
        """Drop one reference; the page returns to the pool at refcount 0."""
        if self._refs[page] < 1:
            raise RuntimeError(f"page {page} released at refcount 0")
        self._refs[page] -= 1
        if self._refs[page]:
            return False
        for key in self._page_keys.pop(page, ()):      # purge its prefixes
            if self._prefix_index.get(key) == page:
                del self._prefix_index[key]
        self._free.append(page)
        return True

    def grow(self, num_pages: int) -> int:
        """Append free pages so the pool holds ``num_pages`` in all (the
        device pool is requantized and padded along its page axis at the
        same moment, so ids 0..old-1 and every block table stay valid).
        Returns the number of pages added."""
        if num_pages < self.num_pages:
            raise ValueError(f"cannot shrink the pool from {self.num_pages} "
                             f"to {num_pages} pages")
        added = list(range(self.num_pages, num_pages))
        self._refs.extend([0] * len(added))
        self._free.extend(added)
        self._free.sort(reverse=True)
        self.num_pages = num_pages
        return len(added)

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow rid's table to cover ``n_tokens``; False (and nothing
        allocated) under page pressure. Never shrinks."""
        table = self._tables.setdefault(rid, [])
        need = self.pages_for(n_tokens) - len(table)
        if need > len(self._free):
            if not table:
                del self._tables[rid]
            return False
        for _ in range(need):
            table.append(self._pop_free())
        return True

    def set_length(self, rid: int, n_tokens: int) -> None:
        """Record rid's token count; its pages must already cover it."""
        if self.pages_for(n_tokens) > self.pages_of(rid):
            raise ValueError(f"request {rid}: {n_tokens} tokens exceed its "
                             f"{self.pages_of(rid)} pages")
        self._lengths[rid] = int(n_tokens)

    def free(self, rid: int) -> int:
        """Drop rid's reference on all of its pages; returns how many went
        back to the pool."""
        if rid not in self._tables:
            raise ValueError(f"request {rid} holds no pages")
        pages = self._tables.pop(rid)
        self._lengths.pop(rid, None)
        returned = sum(self._release(p) for p in pages)
        self._free.sort(reverse=True)
        return returned

    # ------------------------------------------------------ prefix sharing
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest indexed chain covering ``tokens``: (tokens covered,
        pages). Full pages match in order until the first miss; when every
        full page matched and the whole remainder is indexed as a partial
        tail, that page joins too (the request then writes nothing at
        prefill, and its first append copies the shared tail)."""
        ps = self.page_size
        toks = tuple(tokens)
        pages: List[int] = []
        covered, parent = 0, -1
        for j in range(1, len(toks) // ps + 1):
            page = self._prefix_index.get((parent, toks[(j - 1) * ps:j * ps]))
            if page is None:
                break
            pages.append(page)
            covered = j * ps
            parent = page
        rem = len(toks) - covered
        if 0 < rem < ps and covered == (len(toks) // ps) * ps:
            page = self._prefix_index.get((parent, toks[covered:]))
            if page is not None:
                pages.append(page)
                covered = len(toks)
        return covered, pages

    def adopt_prefix(self, rid: int, tokens: Sequence[int]) -> int:
        """Point rid's leading table entries at the resident pages holding
        ``tokens``' longest indexed prefix (refcount + 1 each). Runs at
        admission on an empty table, before ``ensure``; ``free(rid)`` rolls
        it back. Returns the prompt tokens covered."""
        if self._tables.get(rid):
            raise ValueError(f"adopt_prefix on a non-empty table for rid "
                             f"{rid}")
        covered, pages = self.match_prefix(tokens)
        if not pages:
            return 0
        for p in pages:
            self._refs[p] += 1
        self._tables[rid] = pages
        return covered

    def register_prefix(self, rid: int, tokens: Sequence[int]) -> int:
        """Index rid's prompt pages for later arrivals: each full page under
        (parent page, its tokens), and a partial tail under its whole
        remainder. The first registration of a key wins. Returns the new
        index entries."""
        ps = self.page_size
        toks = tuple(tokens)
        table = self._tables.get(rid, ())
        added, parent = 0, -1
        for j in range(1, len(toks) // ps + 1):
            added += self._index((parent, toks[(j - 1) * ps:j * ps]),
                                 table[j - 1])
            parent = table[j - 1]
        if len(toks) % ps and len(toks) // ps < len(table):
            added += self._index((parent, toks[(len(toks) // ps) * ps:]),
                                 table[len(toks) // ps])
        return added

    def _index(self, key: Tuple, page: int) -> int:
        if key in self._prefix_index:
            return 0
        self._prefix_index[key] = page
        self._page_keys.setdefault(page, []).append(key)
        return 1

    def fork_chain(self, parent: int, child: int, cow_tail: bool = False
                   ) -> Optional[Tuple[int, int]]:
        """Fork ``parent``'s chain under ``child``: every page gains a
        reference and the child gets a copy of the table (no page copies).
        ``cow_tail`` also gives the child a private copy of a partial tail
        page (sibling forks). Returns the (src, dst) pair to copy on the
        device, ``()`` when none is needed, or None under page pressure
        (nothing changed)."""
        if self._tables.get(child):
            raise ValueError(f"fork_chain onto a non-empty table for rid "
                             f"{child}")
        table = self._tables[parent]
        n_tok = self._lengths.get(parent, 0)
        tail = n_tok % self.page_size
        if cow_tail and table and tail and not self._free:
            return None
        for p in table:
            self._refs[p] += 1
        self._tables[child] = list(table)
        if parent in self._lengths:
            self._lengths[child] = n_tok
        if cow_tail and table and tail:
            return self.cow_page(child, len(table) - 1)
        return ()

    def commit_fork(self, parent: int, child: int) -> int:
        """Accept a fork: ``parent`` takes ``child``'s table and length and
        drops its references on the old table. Returns the pages returned
        to the pool."""
        child_table = self._tables.pop(child)
        child_len = self._lengths.pop(child, None)
        old = self._tables[parent]
        self._tables[parent] = child_table
        returned = sum(self._release(p) for p in old)
        self._free.sort(reverse=True)
        if child_len is not None:
            self._lengths[parent] = child_len
        return returned

    def abort_fork(self, child: int) -> int:
        """Reject a fork: one reference dropped on every page it holds.
        Returns the pages returned to the pool."""
        return self.free(child)

    def shared_pages_in(self, rid: int, lo_token: int,
                        hi_token: int) -> List[int]:
        """Logical page indices of rid's table covering tokens [lo_token,
        hi_token) whose page is shared (refcount > 1): the pages an append
        there must copy first."""
        table = self._tables.get(rid, ())
        lo = max(lo_token // self.page_size, 0)
        hi = min(self.pages_for(hi_token), len(table))
        return [j for j in range(lo, hi) if self._refs[table[j]] > 1]

    def cow_page(self, rid: int, logical: int) -> Optional[Tuple[int, int]]:
        """Give rid a private copy of its shared logical page: a fresh page
        takes its place in the table and the original loses one reference.
        Returns (src, dst) for the device copy, or None under page pressure
        (nothing changed)."""
        table = self._tables[rid]
        src = table[logical]
        if self._refs[src] < 2:
            raise ValueError(f"cow_page on unshared page {src} (rid {rid})")
        if not self._free:
            return None
        dst = self._pop_free()
        table[logical] = dst
        self._release(src)
        return src, dst

    def block_table_rows(self, rids: List[int], max_pages: int) -> np.ndarray:
        """(len(rids), max_pages) int32 table, -1 where no page is held."""
        bt = np.full((len(rids), max_pages), -1, np.int32)
        for i, rid in enumerate(rids):
            pages = self._tables.get(rid, ())
            if len(pages) > max_pages:
                raise ValueError(f"request {rid} holds {len(pages)} pages, "
                                 f"more than {max_pages}")
            bt[i, :len(pages)] = pages
        return bt

    def observe(self, metrics) -> None:
        """Publish the pool gauges into a ``telemetry.MetricsRegistry`` (once
        per sync window): the occupancy record drift detection reads."""
        used = self.in_use
        metrics.gauge("pages_used", used)
        metrics.gauge("pages_free", len(self._free))
        metrics.gauge("pool_pressure",
                      used / self.num_pages if self.num_pages else 0.0)
        metrics.gauge("shared_page_ratio",
                      sum(1 for r in self._refs if r > 1) / max(used, 1))
        metrics.gauge("resident_tokens", sum(self._lengths.values()))

    def stats(self) -> Dict[str, float]:
        """Occupancy and the sharing counters. Fragmentation counts logical
        page slots (every holder's table), so it stays in [0, 1] when pages
        are shared."""
        used_tokens = sum(self._lengths.values())
        cap_tokens = sum(len(t) for t in self._tables.values()) \
            * self.page_size
        hist: Dict[int, int] = {}
        for r in self._refs:
            if r:
                hist[r] = hist.get(r, 0) + 1
        pages_saved = sum(r - 1 for r in self._refs if r > 1)
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_free": len(self._free),
            "pages_used": self.in_use,
            "live_requests": len(self._tables),
            "used_tokens": used_tokens,
            "fragmentation": (1.0 - used_tokens / cap_tokens) if cap_tokens
            else 0.0,
            "shared_pages": sum(1 for r in self._refs if r > 1),
            "pages_saved_sharing": pages_saved,
            "tokens_saved_sharing": pages_saved * self.page_size,
            "refcount_histogram": hist,
            "prefix_index_entries": len(self._prefix_index),
        }
