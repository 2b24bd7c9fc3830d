"""Cache sizes, capacity and row accounting (the port's counterpart of
``repro.serve.kvcache``): bytes per slot and per page, whether a batch of
contexts fits a device's memory, the rows a budget holds, and the live
occupancy of a page pool."""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core import dataflow
from repro_torch.core.eyexam import H100_SXM, DeviceRates


def cache_bytes(cfg, batch: int, cache_len: int) -> int:
    """Bytes of the contiguous cache ``decoding.init_cache`` allocates
    (``cache_len`` K/V slots of a global layer, ``min(window, cache_len)``
    of a local one, a recurrent layer's fixed state), counted on the meta
    device, which gives shapes and dtypes without allocating."""
    from repro_torch.models import decoding
    return _tree_bytes(decoding.init_cache(cfg, batch, cache_len,
                                           device="meta"))


def kv_page_bytes(cfg, page_size: int, kv_quant: str = "fp") -> int:
    """Bytes one physical page costs across every global layer's K and V
    pool, the int8 format's scales included."""
    from repro_torch.core.plan import num_global_layers
    return dataflow.paged_kv_bytes(1, page_size, cfg.num_kv_heads,
                                   cfg.head_dim, num_global_layers(cfg),
                                   kv_quant)


def paged_cache_bytes(cfg, rows: int, cache_len: int, num_pages: int,
                      page_size: int, kv_quant: str = "fp") -> int:
    """Bytes of the paged cache ``decoding.init_paged_cache`` allocates
    (global layers in a ``num_pages`` pool, local rings per row; int8 pools
    with their scales), counted on the meta device, which gives shapes and
    dtypes without allocating."""
    from repro_torch.models import decoding
    cache = decoding.init_paged_cache(cfg, rows, cache_len, num_pages,
                                      page_size, kv_quant, device="meta")
    return _tree_bytes(cache)


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_tree_bytes(v) for v in tree.values())


def cache_bytes_per_chip(cfg, batch: int, cache_len: int, chips: int,
                         sharded: bool = True) -> float:
    total = cache_bytes(cfg, batch, cache_len)
    return total / chips if sharded else float(total)


def max_slots(cfg, cache_len: int, chips: int,
              hbm_budget_fraction: float = 0.5,
              rates: DeviceRates = H100_SXM) -> int:
    """Dense ``(1, cache_len)`` slots that ``hbm_budget_fraction`` of
    ``rates``' device memory holds; 0 when not even one fits."""
    per_slot = cache_bytes(cfg, 1, cache_len) / chips
    budget = rates.hbm_cap * hbm_budget_fraction
    return int(budget // max(per_slot, 1))


class SlotAllocator:
    """Tracks which device rows are live; pop order yields row 0 first."""

    def __init__(self, slots: int):
        self.slots = slots
        self._free = list(range(slots - 1, -1, -1))
        self._live = set()

    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.slots - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        s = self._free.pop()
        self._live.add(s)
        return s

    def alloc_many(self, n: int) -> List[int]:
        """Allocate n rows at once, all or nothing."""
        if n > len(self._free):
            raise RuntimeError(
                f"requested {n} slots, only {len(self._free)} free")
        return [self.alloc() for _ in range(n)]

    def free(self, slot: int) -> None:
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not live")
        self._live.remove(slot)
        self._free.append(slot)

    def free_many(self, slots) -> None:
        for s in slots:
            self.free(s)

    def live_slots(self) -> List[int]:
        return sorted(self._live)


def report(cfg, batch: int, cache_len: int, chips: int, pager=None,
           kv_quant: str = "fp",
           rates: DeviceRates = H100_SXM) -> Dict[str, float]:
    """Capacity report against ``rates``' device memory. With a
    ``serve.paging.PageAllocator`` as ``pager`` it adds the pool's live
    occupancy (``pager.stats()``) with its byte-valued sharing saving in
    the pool's page format (``kv_quant``)."""
    total = cache_bytes(cfg, batch, cache_len)
    out = {
        "total_gb": total / 1e9,
        "per_chip_gb": total / chips / 1e9,
        "fits": total / chips < rates.hbm_cap,
        "max_slots_half_hbm": max_slots(cfg, cache_len, chips, rates=rates),
    }
    if pager is not None:
        st = pager.stats()
        page_b = kv_page_bytes(cfg, pager.page_size, kv_quant)
        st["kv_quant"] = kv_quant
        st["page_bytes"] = page_b
        # pages other requests reference instead of allocating
        st["bytes_saved_sharing"] = st["pages_saved_sharing"] * page_b
        out["paged"] = st
    return out
