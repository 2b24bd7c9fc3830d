"""Paged KV accounting: fixed-size pages and per-request block tables.

The port's host-side copy of ``repro.serve.paging.PageAllocator`` without
prefix sharing and forks (those are not ported yet). A ``PageAllocator`` owns
``num_pages`` pages and, per request, a block table: the ordered physical page
ids holding that request's KV history. Every page carries a refcount (0 or 1
while nothing is shared), which the guard's pool auditor checks against the
tables. Allocation is all-or-nothing, so the scheduler can probe for pressure
before touching device state, and pop order is deterministic (lowest free
page first), so block tables are reproducible. ``grow`` is the allocator's
half of the int8 degradation rung.
"""
from __future__ import annotations

from typing import Dict, List

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

    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_of(self, rid: int) -> int:
        return len(self._tables.get(rid, ()))

    def table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def pages_for(self, n_tokens: int) -> int:
        return dataflow.pages_for(n_tokens, self.page_size)

    def snapshot(self) -> Dict:
        """Copy of the allocator's state for the pool auditor
        (``guard.audit_pool``), in the reference's layout: the prefix index
        and its reverse map are empty here."""
        return {
            "free": list(self._free),
            "refs": list(self._refs),
            "tables": {rid: list(t) for rid, t in self._tables.items()},
            "lengths": dict(self._lengths),
            "prefix_index": {},
            "page_keys": {},
        }

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
        """Occupancy, with the reference's sharing counters (all zero while
        nothing is shared)."""
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
            "prefix_index_entries": 0,
        }
