"""Cache sizes and row accounting (the port's copy of the parts of
``repro.serve.kvcache`` the plan and the scheduler read)."""
from __future__ import annotations

from typing import List

from repro_torch.core import dataflow


def cache_bytes(cfg, batch: int, cache_len: int) -> int:
    """Bytes of the contiguous cache ``decoding.init_cache`` allocates:
    bf16 K and V of ``batch`` rows for every layer, ``cache_len`` slots for
    a global layer and ``min(window, cache_len)`` for a local one."""
    slots = sum(min(cfg.window_size, cache_len)
                if cfg.layer_kind(i) == "local" else cache_len
                for i in range(cfg.num_layers))
    return 2 * batch * slots * cfg.num_kv_heads * cfg.head_dim * 2


def kv_page_bytes(cfg, page_size: int, kv_quant: str = "fp") -> int:
    """Bytes one physical page costs across every global layer's K and V
    pool, the int8 format's scales included."""
    from repro_torch.core.plan import num_global_layers
    return dataflow.paged_kv_bytes(1, page_size, cfg.num_kv_heads,
                                   cfg.head_dim, num_global_layers(cfg),
                                   kv_quant)


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
