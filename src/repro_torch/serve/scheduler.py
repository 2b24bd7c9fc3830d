"""Continuous-batching scheduler over a paged (or contiguous) KV cache.

The port's counterpart of ``repro.serve.scheduler.ContinuousBatchingScheduler``
as the reference runs it with no guard, one replica and no fault injection:

* arrival-gated admission on a virtual clock that advances ``sync_every``
  steps per decode chunk, jumping over idle gaps;
* paged KV: live rows reserve their next chunk's pages before anything is
  admitted; under page pressure the latest-admitted row is preempted (its
  pages freed, its request requeued and later recomputed by a full
  re-prefill of prompt plus the tokens it had produced);
* admission into freed rows, bucketed into power-of-two length tiers and
  batch-prefilled straight into the pool pages (``decoding.PagedPrefill``);
* decode in chunks of ``sync_every`` device steps whose sampled tokens reach
  the host in one transfer per chunk (``engine.DecodeLoop``: on the card
  each step is one replay of a captured CUDA graph, captured at the first
  run and reused by every later one); streaming ``on_token`` callbacks;
  rows leave at EOS or when their budget is spent, and their pages return
  at once.

Not ported yet, and refused rather than ignored: copy-on-write prefix sharing,
speculative decoding, tensor/expert-parallel plans and the serving guard that
walks a plan's degradation ladder (``check_plan``). A plan's ``degrade`` field
only authorises rungs for that guard; without one the reference ignores it
too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import dataflow
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import (DecodeLoop, build_tier_batch,
                                      refill_rows, resolve_device,
                                      synchronize)
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.kvcache import SlotAllocator
from repro_torch.serve.paging import PageAllocator


@dataclasses.dataclass
class StreamRequest:
    """A request with arrival and latency stamps and optional streaming.

    ``arrival`` and the ``*_at`` stamps are on the scheduler's virtual clock
    (decode steps); ``finished_wall_s`` is seconds from the run's start.
    ``on_token(request, token)`` is called for every generated token, in
    order, at the sync boundary that produced it; ``out`` always collects
    them."""
    rid: int
    prompt: List[int]
    max_new: int
    arrival: float = 0.0
    out: List = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    finished_wall_s: Optional[float] = None
    preemptions: int = 0


def check_plan(plan) -> None:
    """Raise NotImplementedError for plan features the port does not serve."""
    if plan.share_prefix:
        raise NotImplementedError(
            "copy-on-write prefix sharing (share_prefix=True) is not ported "
            "yet: plan with share_prefix=False")
    if plan.spec_k:
        raise NotImplementedError(
            f"speculative decoding (spec_k={plan.spec_k}) is not ported yet")
    if plan.tp * plan.ep > 1:
        raise NotImplementedError(
            f"sharded serving (tp={plan.tp}, ep={plan.ep}) is not ported yet")
    if plan.rows < 1:
        raise ValueError(f"rows must be >= 1, got {plan.rows}")


class ContinuousBatchingScheduler:
    """Streaming continuous batching for one model on one device; every
    dispatch decision is read from ``plan`` (a ``core.plan.ServePlan``).
    ``device`` defaults to the card, as ``LLM``'s does, and construction
    raises without one unless ``device="cpu"`` is passed. ``graphs=False``
    runs the eager decode step on the card, for comparison."""

    def __init__(self, cfg, params, plan, *, eos_id: int = 1,
                 temperature: float = 0.0, device=None, graphs: bool = True):
        check_plan(plan)
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.device = resolve_device(device)
        self.rows = plan.rows
        self.cache_len = plan.cache_len
        self.sync_every = max(1, plan.sync_every)
        self.paged = plan.paged
        self.page_size = plan.page_size
        self.max_pages = plan.max_pages
        self.num_pages = plan.num_pages if self.paged else 0
        self.kv_quant = plan.kv_quant
        self.eos_id = eos_id
        self.temperature = temperature
        self._loop = DecodeLoop(cfg, params, plan, temperature=temperature,
                                eos_id=eos_id, device=self.device,
                                paged=self.paged, sync_every=self.sync_every,
                                graphs=graphs)
        self.pager: Optional[PageAllocator] = None
        self.phase_stats: Dict = {}

    @property
    def graph(self) -> Optional[StepGraph]:
        """The captured decode step (None on the CPU, with graphs=False,
        or before the first run)."""
        return self._loop.graph

    # -------------------------------------------------------------- host loop
    def _plen(self, r: StreamRequest) -> int:
        """Prompt length at (re-)admission: the prompt plus whatever was
        generated before a preemption (recompute resume)."""
        return len(r.prompt) + len(r.out)

    @staticmethod
    def _resume_prompt(r: StreamRequest) -> List[int]:
        return list(r.prompt) + [int(t) for t in r.out]

    @staticmethod
    def _final_len(r: StreamRequest) -> int:
        return len(r.prompt) + r.max_new

    def _validate(self, requests: List[StreamRequest]) -> None:
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError(f"request rids must be unique, got {rids}")
        for r in requests:
            total = len(r.prompt) + r.max_new
            if r.max_new > 0 and total > self.cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({len(r.prompt)}) + max_new "
                    f"({r.max_new}) exceeds cache_len ({self.cache_len})")
            need = dataflow.pages_for(total, self.page_size)
            if self.paged and r.max_new > 0 and need > self.num_pages:
                raise ValueError(f"request {r.rid} needs {need} pages, pool "
                                 f"has {self.num_pages}: it can never run")

    def run(self, requests: List[StreamRequest], seed: int = 0
            ) -> List[StreamRequest]:
        """Serve ``requests`` to completion; returns them in finishing order.
        ``seed`` seeds the sampler (unused when greedy)."""
        self._validate(requests)
        T = self.sync_every
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        waiting: List[StreamRequest] = []
        done: List[StreamRequest] = []
        pager = self.pager = PageAllocator(self.num_pages, self.page_size) \
            if self.paged else None
        alloc = SlotAllocator(self.rows)
        active: Dict[int, StreamRequest] = {}          # row -> request
        row_pos: Dict[int, int] = {}                   # row -> device pos
        admit_order: List[int] = []                    # rows, oldest first
        row_rids = [-1] * self.rows
        state = self._loop.start(seed)
        clock = 0.0
        t_start = time.perf_counter()
        st = self.phase_stats = {
            "prefill_s": 0.0, "decode_s": 0.0, "prefill_batches": 0,
            "prefill_prompts": 0, "prefill_real_tokens": 0,
            "prefill_padded_tokens": 0, "decode_chunks": 0,
            "decode_steps": 0, "idle_steps": 0.0, "preemptions": 0,
            "peak_live_rows": 0,
            "attn_path": "paged" if self.paged else "contiguous",
            "kv_quant": self.kv_quant}
        preempted_rows: List[int] = []
        just_preempted: set = set()
        peak_pages: Optional[Dict] = None

        def resolve(r: StreamRequest):
            r.done = True
            if r.finished_at is None:
                r.finished_at = clock
            r.finished_wall_s = time.perf_counter() - t_start
            done.append(r)

        for r in [r for r in pending if r.max_new <= 0]:
            pending.remove(r)
            r.finished_at = r.arrival
            resolve(r)

        def clear_preempted_flags():
            """Dead-flag the rows preempted since the last call, before a
            row is reused and before every chunk."""
            if preempted_rows:
                state[3][torch.as_tensor(preempted_rows,
                                         device=self.device)] = False
                preempted_rows.clear()

        def preempt_latest() -> bool:
            """Free the latest-admitted row and requeue its request for
            recompute; False when only one row is left."""
            if len(admit_order) <= 1:
                return False
            row = admit_order.pop()
            r = active.pop(row)
            pager.free(r.rid)
            alloc.free(row)
            row_rids[row] = -1
            row_pos.pop(row, None)
            r.preemptions += 1
            st["preemptions"] += 1
            preempted_rows.append(row)
            just_preempted.add(r.rid)
            waiting.append(r)
            waiting.sort(key=lambda w: (w.arrival, w.rid))
            return True

        def block_table():
            """The rows' tables, copied into the loop's static buffer."""
            return self._loop.set_block_table(pager.block_table_rows(
                row_rids, self.max_pages)) if self.paged else None

        while pending or waiting or active:
            # ---- arrivals (virtual clock; idle-jump when nothing to do)
            while pending and pending[0].arrival <= clock + 1e-9:
                waiting.append(pending.pop(0))
            if not active and not waiting:
                st["idle_steps"] += pending[0].arrival - clock
                clock = pending[0].arrival
                continue

            # ---- page headroom for the live rows' next chunk, oldest first
            if self.paged:
                for row in list(admit_order):
                    if row not in active:
                        continue
                    r = active[row]
                    need = min(row_pos[row] + T, self._final_len(r))
                    while row in active and not pager.ensure(r.rid, need):
                        if not preempt_latest():
                            raise RuntimeError(
                                "page pool exhausted with nothing left to "
                                "preempt: num_pages is too small")
                    if row in active:
                        pager.set_length(r.rid, row_pos[row])
            clear_preempted_flags()

            # ---- admission of arrived requests into free rows
            to_admit: List[StreamRequest] = []
            while waiting and len(to_admit) < alloc.available():
                r = waiting[0]
                if r.rid in just_preempted:
                    break        # evicted this boundary: wait one, keep rank
                if self.paged and not pager.ensure(
                        r.rid, min(self._plen(r) + T, self._final_len(r))):
                    break        # page pressure: wait for frees
                waiting.pop(0)
                to_admit.append(r)
            just_preempted.clear()
            admits: List[Tuple[int, StreamRequest]] = list(
                zip(alloc.alloc_many(len(to_admit)), to_admit))
            for row, r in admits:
                admit_order.append(row)
                row_rids[row] = r.rid
                row_pos[row] = self._plen(r)
                if self.paged:
                    pager.set_length(r.rid, row_pos[row])
                if r.admitted_at is None:
                    r.admitted_at = clock
            if admits:
                buckets: Dict[int, List[Tuple[int, StreamRequest]]] = {}
                for row, r in admits:
                    buckets.setdefault(self.plan.tier(self._plen(r)),
                                       []).append((row, r))
                bt = block_table()
                t0 = time.perf_counter()
                for tier, group in sorted(buckets.items()):
                    toks, lengths, slots, budgets = build_tier_batch(
                        group, tier, self._resume_prompt,
                        lambda r: r.max_new - len(r.out))
                    for row, r in group:
                        active[row] = r
                    refill_rows(self.params, self.cfg, self.plan, state,
                                toks, lengths, slots, budgets,
                                block_table=bt)
                    st["prefill_batches"] += 1
                    st["prefill_prompts"] += len(group)
                    st["prefill_real_tokens"] += int(lengths.sum())
                    st["prefill_padded_tokens"] += len(group) * tier
                synchronize(self.device)
                st["prefill_s"] += time.perf_counter() - t0

            if not active:
                continue
            st["peak_live_rows"] = max(st["peak_live_rows"], len(active))
            if self.paged:
                s = pager.stats()
                if peak_pages is None or \
                        s["pages_used"] > peak_pages["pages_used"]:
                    peak_pages = s

            # ---- one decode chunk on the device, one transfer back
            t0 = time.perf_counter()
            block_table()
            toks_h, emits_h, live_h = self._loop.chunk()
            st["decode_s"] += time.perf_counter() - t0
            st["decode_chunks"] += 1
            st["decode_steps"] += T
            clock += T
            for t in range(T):
                for row, r in active.items():
                    if emits_h[t, row]:
                        tok = int(toks_h[t, row])
                        r.out.append(tok)
                        if r.first_token_at is None:
                            r.first_token_at = clock - T + t + 1
                        if r.on_token is not None:
                            r.on_token(r, tok)
            freed_rows: List[int] = []
            for row in list(active):
                row_pos[row] += T
                if not live_h[row]:
                    r = active.pop(row)
                    freed_rows.append(row)
                    admit_order.remove(row)
                    row_rids[row] = -1
                    row_pos.pop(row, None)
                    if self.paged:
                        pager.free(r.rid)        # pages return immediately
                    resolve(r)
            alloc.free_many(freed_rows)

        st["total_wall_s"] = time.perf_counter() - t_start
        st["clock_steps"] = clock
        if self.paged:
            st["pages"] = pager.stats()              # drained end state
            st["pages_peak"] = peak_pages            # busiest boundary
        return done
