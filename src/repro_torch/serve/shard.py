"""Mesh-sharded serving: the serve mesh and the distributed page pool.

The port's copy of ``repro.serve.shard``. Eyeriss v2's hierarchical mesh
picks a NoC mode per data type to match its reuse; the ``ServePlan``'s
mesh stage (``core.plan``) does the same at cluster scale, tp sharding the
attention KV heads and ep the MoE expert axis:

=============  ====================  =======================================
data type      NoC mode              why
=============  ====================  =======================================
weights        BROADCAST             decode is weight-stream bound; a
                                     sharded store would re-gather onto the
                                     critical path every step
KV pages       GROUPED_MC (local)    attention is per-KV-head local: each
                                     shard streams only its 1/tp slice
activations    UNICAST→all-gather    head contexts are produced as unique
                                     1/tp slices and gathered full-width
experts        INTERLEAVED_MC        the expert axis is a batch axis in the
                                     decode products; the combine runs on
                                     the gathered full-E tensor
=============  ====================  =======================================

This module is the host side: :class:`ServeMesh` (the resolved mesh and
whether real devices back it), :class:`ShardedPagePool` (one
``PageAllocator`` per tp shard, in lockstep over one block table), the
partition specs, and the analytic collective accounting the scheduler
counts under the ``collective`` trace category. The device side (per-shard
kernel launches and the exact concatenations that make a sharded step
bit-identical to one device) is ``sharding.tensor_parallel``.

As in the reference, serving runs the shards as one program on the serving
device: every shard's kernels run on that device, one after another, and
:meth:`ServeMesh.device_mesh` (which names a device per shard when enough
are present) is never called by serving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import hmmesh
from repro_torch.serve import kvcache, paging


# -------------------------------------------------------------- serve mesh
@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The resolved serving mesh: ``tp`` x ``ep`` shards, logical unless
    enough devices of type ``device`` (``"cuda"`` or ``"cpu"``) back it.
    The sharded program is exact math over one device, so it runs (and is
    tested bit-identical) anywhere; ``backed`` reports whether each shard
    could have a device of its own."""
    tp: int = 1
    ep: int = 1
    device: str = "cuda"

    @classmethod
    def from_plan(cls, plan, device="cuda") -> "ServeMesh":
        return cls(tp=getattr(plan, "tp", 1) or 1,
                   ep=getattr(plan, "ep", 1) or 1,
                   device=torch.device(device).type)

    @property
    def devices(self) -> int:
        return self.tp * self.ep

    @property
    def trivial(self) -> bool:
        return self.devices == 1

    def _available(self) -> int:
        """Devices of this mesh's type: CUDA cards, or one CPU."""
        if self.device == "cuda":
            return torch.cuda.device_count()
        return 1

    @property
    def backed(self) -> bool:
        return self._available() >= self.devices

    def device_mesh(self) -> List[List[torch.device]]:
        """The first ``devices`` devices as an (ep, tp) nested list, one per
        shard; only meaningful when :attr:`backed`."""
        if not self.backed:
            raise RuntimeError(
                f"mesh tp={self.tp} ep={self.ep} needs {self.devices} "
                f"device(s), host has {self._available()} ("
                + ("torch.cuda.device_count()" if self.device == "cuda"
                   else "one CPU") + ") — run on a host with that many "
                "cards or serve logically")
        if self.device != "cuda":
            return [[torch.device(self.device)]]
        return [[torch.device("cuda", e * self.tp + t)
                 for t in range(self.tp)] for e in range(self.ep)]

    def describe(self) -> str:
        backing = "backed" if self.backed else \
            f"logical ({self._available()} {self.device} device(s))"
        return f"tp={self.tp} ep={self.ep} ({self.devices} devices, {backing})"


# --------------------------------------------------------- partition specs
def partition_specs(plan) -> Dict[str, Dict]:
    """Per-data-type placement read off the plan's mesh: each entry names
    the ``hmmesh.Mode`` and the spec (one entry per dimension, see
    ``core.hmmesh``) that realizes it on :meth:`ServeMesh.device_mesh`'s
    ("ep", "tp") axes. KV pools are (P, page_size, KV, D): the head axis
    shards over tp; expert weights are (E, d, f): the expert axis shards
    over ep; everything else replicates."""
    tp = getattr(plan, "tp", 1) or 1
    ep = getattr(plan, "ep", 1) or 1
    return {
        "weights": {"mode": hmmesh.Mode.BROADCAST, "spec": ()},
        "kv_pages": {"mode": hmmesh.Mode.GROUPED_MC,
                     "spec": (None, None, "tp" if tp > 1 else None, None)},
        "activations": {"mode": hmmesh.Mode.BROADCAST, "spec": (),
                        "note": "produced UNICAST per shard, all-gathered"},
        "experts": {"mode": hmmesh.Mode.INTERLEAVED_MC,
                    "spec": ("ep" if ep > 1 else None, None, None)},
    }


# ------------------------------------------------------ sharded page pool
# PageAllocator methods that change allocator state: applied to every shard
# in lockstep, their results required identical
_MUTATING = ("grow", "ensure", "set_length", "free", "adopt_prefix",
             "register_prefix", "fork_chain", "commit_fork", "abort_fork",
             "cow_page")
# read-only queries: the metadata is replicated, shard 0 answers
_READONLY = ("available", "pages_of", "table", "live_requests", "pages_for",
             "refcount", "snapshot", "fingerprint", "match_prefix",
             "shared_pages_in", "block_table_rows", "num_pages", "page_size",
             "in_use")


class ShardedPagePool:
    """``tp`` :class:`~repro_torch.serve.paging.PageAllocator`\\ s over one
    distributed address space.

    Page frames are per shard (frame ``p`` of shard ``s`` holds the KV-head
    slice ``s`` of logical page ``p``); the allocation metadata (free
    lists, refcounts, the prefix index, block tables) is replicated: every
    mutating call runs on all shards and must return the same result on
    each (asserted: lockstep is what lets one block-table row name valid
    frames on every shard). Prefix sharing and the degradation ladder run
    per shard pool with no coordination, and the scheduler uses this class
    as it uses one ``PageAllocator``."""

    def __init__(self, num_pages: int, page_size: int, shards: int):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = tuple(paging.PageAllocator(num_pages, page_size)
                            for _ in range(shards))

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "shards":
            raise AttributeError(name)
        if name in _MUTATING:
            def lockstep(*a, __name=name, **kw):
                results = [getattr(s, __name)(*a, **kw) for s in self.shards]
                first = results[0]
                assert all(r == first for r in results[1:]), (
                    f"sharded pool divergence in {__name}: {results} — "
                    "per-device allocators fell out of lockstep")
                return first
            return lockstep
        if name in _READONLY:
            return getattr(self.shards[0], name)
        raise AttributeError(name)

    def lockstep_divergence(self) -> int:
        """Shards whose state differs from shard 0's (0 = healthy):
        the ``shard_lockstep_divergence`` gauge."""
        fps = [s.fingerprint() for s in self.shards]
        return sum(1 for fp in fps[1:] if fp != fps[0])

    def observe(self, metrics) -> None:
        """The pool gauges of shard 0, plus the per-shard occupancy spread
        and the lockstep divergence."""
        self.shards[0].observe(metrics)
        used = [s.in_use for s in self.shards]
        metrics.gauge("shard_pages_used_max", max(used))
        metrics.gauge("shard_pages_used_min", min(used))
        metrics.gauge("shard_lockstep_divergence",
                      self.lockstep_divergence())

    def stats(self) -> Dict[str, float]:
        st = self.shards[0].stats()
        st["shards"] = len(self.shards)
        st["lockstep_divergence"] = self.lockstep_divergence()
        return st


def make_pool(plan, num_pages: Optional[int] = None):
    """The plan's page pool: a :class:`ShardedPagePool` (one allocator per
    tp shard) for a sharded paged plan, else one ``PageAllocator``; of
    ``num_pages`` pages (default the plan's: a scheduler past the int8
    rung passes its grown count)."""
    tp = getattr(plan, "tp", 1) or 1
    n = plan.num_pages if num_pages is None else num_pages
    if getattr(plan, "sharded", False) and plan.paged and tp > 1:
        return ShardedPagePool(n, plan.page_size, shards=tp)
    return paging.PageAllocator(n, plan.page_size)


# ------------------------------------------------- collective accounting
def chunk_collectives(plan, *, steps: int, tokens: int) -> Dict[str, int]:
    """The analytic collective traffic of one decode chunk, from the plan's
    mesh decisions: one head-context all-gather per attention layer per
    step (tp), one expert gather per MoE layer per step (ep); counted
    under the ``collective_*`` metric keys, which drift detection holds
    against the mesh decision."""
    dec = {d.name: d for d in getattr(plan, "decisions", ())}
    mesh = dec.get("mesh")
    if mesh is None:
        return {}
    acts = dec.get("noc_acts")
    n_attn = int(acts.numbers.get("attn_layers", 0)) if acts else 0
    n_moe = int(dec["noc_experts"].numbers.get("moe_layers", 0)) \
        if "noc_experts" in dec else 0
    ops_per_step = (n_attn if plan.tp > 1 else 0) \
        + (n_moe if plan.ep > 1 else 0)
    per_tok = int(mesh.numbers.get("allgather_bytes_per_token", 0))
    return {"collective_ops": int(steps) * ops_per_step,
            "collective_allgather_bytes": per_tok * int(tokens)}


def per_device_kv_bytes(cfg, plan) -> int:
    """Bytes of the paged KV pool one tp shard holds (its 1/tp KV-head
    slice of every page frame): the fp payload and the int8 scales are both
    linear in the head axis, and the plan enforces tp | num_kv_heads, so
    the division is exact."""
    if not plan.paged:
        return 0
    total = kvcache.kv_page_bytes(cfg, plan.page_size, plan.kv_quant) \
        * plan.num_pages
    return total // (plan.tp if plan.tp > 1 else 1)


def sharding_stats(cfg, plan, pool=None, device="cuda") -> Dict:
    """One report: the resolved mesh, whether ``device``'s backend backs
    it, single- and per-device pool bytes, and (with a pool) the live
    per-shard occupancy."""
    mesh = ServeMesh.from_plan(plan, device)
    single = kvcache.kv_page_bytes(cfg, plan.page_size, plan.kv_quant) \
        * plan.num_pages if plan.paged else 0
    out = {"tp": mesh.tp, "ep": mesh.ep, "devices": mesh.devices,
           "backed": mesh.backed,
           "kv_bytes_single_device": single,
           "kv_bytes_per_device": per_device_kv_bytes(cfg, plan)}
    if isinstance(pool, ShardedPagePool):
        out["shards"] = len(pool.shards)
        out["shard_pages_used"] = [s.in_use for s in pool.shards]
        out["lockstep_divergence"] = pool.lockstep_divergence()
    return out
