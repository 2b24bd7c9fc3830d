"""Paged KV accounting: fixed-size pages and per-request block tables.

The port's host-side copy of ``repro.serve.paging.PageAllocator`` without
prefix sharing and forks (those are not ported yet). A ``PageAllocator`` owns
``num_pages`` pages and, per request, a block table: the ordered physical page
ids holding that request's KV history. Allocation is all-or-nothing, so the
scheduler can probe for pressure before touching device state, and pop order
is deterministic (lowest free page first), so block tables are reproducible.
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
            table.append(self._free.pop())
        return True

    def set_length(self, rid: int, n_tokens: int) -> None:
        """Record rid's token count; its pages must already cover it."""
        if self.pages_for(n_tokens) > self.pages_of(rid):
            raise ValueError(f"request {rid}: {n_tokens} tokens exceed its "
                             f"{self.pages_of(rid)} pages")
        self._lengths[rid] = int(n_tokens)

    def free(self, rid: int) -> int:
        """Return all of rid's pages to the pool; returns how many."""
        if rid not in self._tables:
            raise ValueError(f"request {rid} holds no pages")
        pages = self._tables.pop(rid)
        self._lengths.pop(rid, None)
        self._free.extend(pages)
        self._free.sort(reverse=True)
        return len(pages)

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

    def stats(self) -> Dict[str, float]:
        used_tokens = sum(self._lengths.values())
        cap_tokens = sum(len(t) for t in self._tables.values()) \
            * self.page_size
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_free": len(self._free),
            "pages_used": self.in_use,
            "live_requests": len(self._tables),
            "used_tokens": used_tokens,
            "fragmentation": (1.0 - used_tokens / cap_tokens) if cap_tokens
            else 0.0,
        }
