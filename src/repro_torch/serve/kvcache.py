"""Row accounting for the scheduler's preallocated decode rows (the port's
copy of ``repro.serve.kvcache.SlotAllocator``)."""
from __future__ import annotations

from typing import List


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
