"""Request placement across replicas: prefix affinity, load, fairness (the
port's copy of ``repro.serve.router``; pure Python).

The fleet (``serve.replica.ReplicaSet``) holds N schedulers, each with its
own page pool and copy-on-write prefix index, so placement decides more than
load balance: a request placed on the replica that already holds its prompt
prefix adopts those pages, where on any other replica it prefills and stores
the same KV again.

* **Prefix affinity**: a request's key is its first KV page of prompt tokens
  (the prefix index shares whole pages only). The first request of a key
  claims a home replica, and followers go home too, unless home's queue
  depth is more than ``max_depth_imbalance`` behind the least-loaded
  replica's, where load wins.
* **Queue depth**: otherwise the replica with the fewest resident requests
  (pending + waiting + active, placements earlier in the same window
  included), the lowest slot on ties.
* **Tenant fairness**: one window's arrivals are dispatched in per-tenant
  round-robin order, (arrival, rid) within a tenant.

The router keeps no view of replica health: on failover the supervisor calls
:meth:`Router.forget_replica`, which drops every claim on the dead replica.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_TENANT = ""


@dataclasses.dataclass
class RouterConfig:
    """``affinity`` turns prefix-affinity routing on (off: least depth
    only); ``max_depth_imbalance`` is how many requests deeper than the
    least-loaded replica the affinity home may run before load wins."""
    affinity: bool = True
    max_depth_imbalance: int = 4


class Router:
    """Places requests onto live replicas and owns the prefix -> home map.
    ``page_size`` is the replicas' plan's: the affinity key is one page of
    prompt."""

    def __init__(self, cfg: Optional[RouterConfig] = None, *,
                 page_size: int = 0):
        self.cfg = cfg or RouterConfig()
        self.page_size = page_size
        self._home: Dict[Tuple[int, ...], int] = {}   # prefix key -> slot
        self.stats = {"placements": 0, "affinity_hits": 0,
                      "affinity_overridden": 0, "forgotten_keys": 0}

    def prefix_key(self, prompt: Sequence[int]) -> Optional[Tuple[int, ...]]:
        """The prompt's first full KV page, or None when affinity is off or
        the prompt is shorter than a page."""
        if not self.cfg.affinity or self.page_size <= 0 \
                or len(prompt) < self.page_size:
            return None
        return tuple(int(t) for t in prompt[: self.page_size])

    def forget_replica(self, slot: int) -> int:
        """Drop every affinity claim on a dead replica; returns how many."""
        dead = [k for k, s in self._home.items() if s == slot]
        for k in dead:
            del self._home[k]
        self.stats["forgotten_keys"] += len(dead)
        return len(dead)

    def place(self, request, replicas: List) -> object:
        """The replica for ``request`` among live ``replicas`` (each with
        ``.slot`` and ``.queue_depth()``). Deterministic: depth ties break on
        the slot, and the affinity map changes in placement order."""
        if not replicas:
            raise RuntimeError("router: no live replicas to place onto")
        by_slot = {rep.slot: rep for rep in replicas}
        depths = {rep.slot: rep.queue_depth() for rep in replicas}
        least = min(replicas, key=lambda rep: (depths[rep.slot], rep.slot))
        chosen = least
        key = self.prefix_key(request.prompt)
        if key is not None:
            home = self._home.get(key)
            if home is not None and home in by_slot:
                if depths[home] <= depths[least.slot] \
                        + self.cfg.max_depth_imbalance:
                    chosen = by_slot[home]
                    self.stats["affinity_hits"] += 1
                else:
                    self.stats["affinity_overridden"] += 1
            self._home[key] = chosen.slot
        self.stats["placements"] += 1
        return chosen

    @staticmethod
    def fair_order(requests: Sequence) -> List:
        """Per-tenant round-robin order for one window: (arrival, rid)
        within a tenant, one request per tenant a round, tenants ordered by
        their earliest (arrival, rid)."""
        queues: Dict[str, List] = {}
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            queues.setdefault(r.tenant or DEFAULT_TENANT, []).append(r)
        order = sorted(queues,
                       key=lambda t: (queues[t][0].arrival, queues[t][0].rid))
        out: List = []
        while any(queues.values()):
            for t in order:
                if queues[t]:
                    out.append(queues[t].pop(0))
        return out
