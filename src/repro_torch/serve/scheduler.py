"""Continuous-batching scheduler over a paged (or contiguous) KV cache.

The port's counterpart of ``repro.serve.scheduler.ContinuousBatchingScheduler``
for one replica, with the serving guard, fault injection and telemetry:

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
  each step is one replay of a captured CUDA graph); streaming ``on_token``
  callbacks; rows leave at EOS or when their budget is spent, and their
  pages return at once.

With a ``guard.GuardConfig`` every request ends in exactly one
``RequestOutcome``: deadlines are swept before admission and for live rows,
a request preempted past ``retry_budget`` resolves ``preempted_out``, a pool
stall past ``stall_budget`` fails the oldest row, and overload walks the
plan's ladder: the ``int8_kv`` rung at the start of a boundary (the pool is
requantized and grown on the device, ``DecodeLoop.quantize_kv``, sticky for
the scheduler's lifetime), then clamp and shed judged at arrival. A
``chaos.ChaosConfig`` injects ensure failures, transient step faults (retried
with ``backoff_delay`` before the chunk's device work) and NaN logits, which
the NaN sweep of ``state[1]`` quarantines. Every trace event and metric is
recorded where the reference records it, under the same name, category and
arguments, so the port's ``Tracer.signature()`` of a run equals the
reference's. A guarded run ends with ``assert_pool_clean(drained=True)``;
every run ends with ``telemetry.detect_drift`` against the plan.

Not ported yet, and refused rather than ignored (``check_plan``):
copy-on-write prefix sharing, speculative decoding and tensor/expert-parallel
plans; the fleet's externally driven runs (``start_gen``/``inject``) wait for
the replica set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dataflow
from repro_torch.models import transformer as tfm
from repro_torch.runtime.fault_tolerance import backoff_delay
from repro_torch.serve import chaos as chaos_mod
from repro_torch.serve import guard as guard_mod
from repro_torch.serve import telemetry as telemetry_mod
from repro_torch.serve.engine import (DecodeLoop, build_tier_batch,
                                      refill_rows, resolve_device)
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
    them. ``ttl`` sets the deadline (arrival + ttl steps; None falls back to
    the guard's ``default_ttl_steps``); ``on_outcome(request, outcome)`` is
    called once with the request's terminal ``outcome``; ``degraded`` lists
    the ladder rungs applied to it; ``tenant`` keys the per-tenant metrics.
    ``shared_tokens`` (prompt tokens served from shared pages) stays 0 until
    prefix sharing is ported."""
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
    shared_tokens: int = 0
    ttl: Optional[float] = None
    on_outcome: Optional[Callable] = None
    outcome: Optional[guard_mod.RequestOutcome] = None
    degraded: List[str] = dataclasses.field(default_factory=list)
    tenant: Optional[str] = None


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
    runs the eager decode step on the card, for comparison.

    ``guard`` (a ``GuardConfig``; None keeps the guard-less behaviour, which
    raises on an exhausted pool) and ``telemetry`` (a shared
    ``serve.telemetry.Telemetry``; the scheduler's own, reset per run, when
    None) are the reference's; ``slot`` tags trace events. ``host_syncs``
    counts the loop's device-to-host transfers: one per decode chunk, plus
    one per NaN sweep when ``nan_check`` or chaos is on."""

    def __init__(self, cfg, params, plan, *, eos_id: int = 1,
                 temperature: float = 0.0, device=None, graphs: bool = True,
                 guard: Optional[guard_mod.GuardConfig] = None,
                 telemetry: Optional[telemetry_mod.Telemetry] = None,
                 slot: int = -1):
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
        self.guard = guard
        if guard is not None and guard.degrade_rungs is not None:
            self._ladder = tuple(r for r in plan.degrade
                                 if r in guard.degrade_rungs)
        else:
            self._ladder = plan.degrade if guard is not None else ()
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_mod.Telemetry()
        self._own_telemetry = telemetry is None
        self.slot = slot
        self.host_syncs = 0
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
        """Caller bugs raise before any work: duplicate rids, a request
        longer than the cache or than the whole pool."""
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

    def _degrade_to_int8(self, clock: float) -> None:
        """The ladder's int8 rung: requantize the live pool to int8 pages
        and grow it to the plan's ``num_pages_int8`` (the same footprint,
        about twice the pages). Page ids 0..old-1 keep their contents, so
        every block table survives. Sticky for the scheduler's lifetime:
        later runs start on the grown int8 pool."""
        new_pages = self.plan.num_pages_int8
        self._loop.quantize_kv(new_pages)
        self.pager.grow(new_pages)
        self.num_pages = new_pages
        self.kv_quant = "int8"
        self.phase_stats["kv_quant"] = "int8"
        self.phase_stats["degraded_to_int8_at"] = clock
        self.telemetry.metrics.count("requant_events")
        self.telemetry.tracer.event("degrade_rung", clock, cat="degrade",
                                    slot=self.slot, rung="int8_kv",
                                    pages=new_pages)

    def run(self, requests: List[StreamRequest], seed: int = 0,
            chaos=None) -> List[StreamRequest]:
        """Serve ``requests`` to completion; returns them in finishing order.
        ``seed`` seeds the sampler (unused when greedy); ``chaos`` takes a
        ``ChaosConfig`` (or a ``FaultInjector``) for deterministic fault
        injection."""
        self._validate(requests)
        g = self.guard
        inj = None
        if chaos is not None:
            inj = chaos if isinstance(chaos, chaos_mod.FaultInjector) \
                else chaos_mod.FaultInjector(chaos)
        tel = self.telemetry
        if self._own_telemetry:
            tel.reset()
        tr, m = tel.tracer, tel.metrics
        slot = self.slot
        clock = 0.0
        if inj is not None:
            # traced at the boundary the injection fired on (late-bound)
            inj.on_inject = lambda kind, rid=-1: tr.event(
                "chaos_inject", clock, cat="chaos", slot=slot, rid=rid,
                kind=kind)
        T = self.sync_every
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        waiting: List[StreamRequest] = []
        done: List[StreamRequest] = []
        pager = self.pager = PageAllocator(self.num_pages, self.page_size) \
            if self.paged else None
        for r in [r for r in pending if r.max_new <= 0]:
            pending.remove(r)
            r.done = True
            r.finished_at = r.arrival
            r.outcome = guard_mod.RequestOutcome(
                "ok", "empty generation budget", at_step=r.arrival)
            if r.on_outcome is not None:
                r.on_outcome(r, r.outcome)
            done.append(r)
        alloc = SlotAllocator(self.rows)
        active: Dict[int, StreamRequest] = {}          # row -> request
        row_pos: Dict[int, int] = {}                   # row -> device pos
        admit_order: List[int] = []                    # rows, oldest first
        row_rids = [-1] * self.rows
        state = self._loop.start(seed)
        stall_streak = 0
        run_clock = telemetry_mod.RunClock()
        st = self.phase_stats = {
            "prefill_s": 0.0, "decode_s": 0.0, "prefill_batches": 0,
            "prefill_prompts": 0, "prefill_real_tokens": 0,
            "prefill_padded_tokens": 0, "decode_chunks": 0,
            "decode_steps": 0, "idle_steps": 0.0, "preemptions": 0,
            "peak_live_rows": 0,
            "attn_path": "paged" if self.paged else "contiguous",
            "kv_quant": self.kv_quant,
            "guard_enabled": g is not None,
            "stalled_boundaries": 0, "step_retries": 0,
            "clamped_admissions": 0}
        preempted_rows: List[int] = []
        just_preempted: set = set()
        peak_pages: Optional[Dict] = None

        def clear_preempted_flags():
            """Dead-flag the rows preempted or evicted since the last call,
            before a row is reused and before every chunk."""
            if preempted_rows:
                state[3][torch.as_tensor(preempted_rows,
                                         device=self.device)] = False
                preempted_rows.clear()

        def resolve(r: StreamRequest, status: str, reason: str = ""):
            """The request's one terminal outcome, delivered through its
            ``on_outcome`` callback; never an exception mid-batch."""
            r.done = True
            if r.finished_at is None:
                r.finished_at = clock
            r.finished_wall_s = run_clock.elapsed_s()
            r.outcome = guard_mod.RequestOutcome(
                status=status, reason=reason, at_step=clock,
                degraded=tuple(r.degraded))
            done.append(r)
            m.count(status)
            m.observe("e2e_latency_steps", r.finished_at - r.arrival)
            if r.first_token_at is not None:
                m.observe("ttft_steps", r.first_token_at - r.arrival)
            if status == "ok":
                m.observe("finished_len_tokens", len(r.prompt) + len(r.out))
                m.observe("generated_tokens", len(r.out))
                m.tenant_count(r.tenant, "ok_requests")
                m.tenant_count(r.tenant, "ok_tokens", len(r.out))
            tr.event("outcome", r.finished_at, cat="request", slot=slot,
                     rid=r.rid, status=status)
            if r.on_outcome is not None:
                r.on_outcome(r, r.outcome)

        def deadline_of(r: StreamRequest) -> Optional[float]:
            ttl = r.ttl if r.ttl is not None else (
                g.default_ttl_steps if g is not None else None)
            return None if ttl is None else r.arrival + ttl

        def evict_active(row: int, status: str, reason: str):
            """Terminal eviction of a live row (expired or failed): pages and
            row returned, partial output kept on the resolved request."""
            r = active.pop(row)
            if self.paged:
                pager.free(r.rid)
            alloc.free(row)
            admit_order.remove(row)
            row_rids[row] = -1
            row_pos.pop(row, None)
            preempted_rows.append(row)
            resolve(r, status, reason)

        def ensure_pages(rid: int, n_tokens: int) -> bool:
            """``pager.ensure`` behind the chaos harness: an injected failure
            looks like genuine pressure and allocates nothing."""
            if inj is not None and inj.ensure_fails(rid, n_tokens):
                return False
            return pager.ensure(rid, n_tokens)

        def preempt_latest() -> bool:
            """Free the latest-admitted row and requeue its request for
            recompute, or resolve it ``preempted_out`` once its retry budget
            is spent; False when only one row is left."""
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
            m.count("preemptions")
            tr.event("preempt", clock, cat="pool", slot=slot, rid=r.rid)
            preempted_rows.append(row)
            if g is not None and r.preemptions > g.retry_budget:
                resolve(r, "preempted_out",
                        f"preempted {r.preemptions} times — retry budget "
                        f"({g.retry_budget}) spent; {len(r.out)} generated "
                        "tokens kept")
                return True
            just_preempted.add(r.rid)
            waiting.append(r)
            waiting.sort(key=lambda w: (w.arrival, w.rid))
            return True

        def note_stall(why: str):
            """A boundary that could not reserve chunk headroom: skip the
            chunk and let the clock run on; a streak past ``stall_budget``
            fails the oldest resident request."""
            nonlocal stall_streak
            st["stalled_boundaries"] += 1
            m.count("stalled_boundaries")
            tr.event("stall", clock, cat="pool", slot=slot, why=why)
            stall_streak += 1
            just_preempted.clear()
            if g is not None and stall_streak > g.stall_budget and \
                    admit_order:
                evict_active(admit_order[0], "failed",
                             f"{why}: {stall_streak} consecutive stalled "
                             f"boundaries (stall_budget {g.stall_budget})")
                stall_streak = 0

        def block_table():
            """The rows' tables, copied into the loop's static buffer."""
            return self._loop.set_block_table(pager.block_table_rows(
                row_rids, self.max_pages)) if self.paged else None

        while pending or waiting or active:
            # ---- the int8 rung (boundary start, measured pressure): it
            # relieves pressure before this boundary's arrivals are judged
            if "int8_kv" in self._ladder and self.paged \
                    and self.kv_quant == "fp" \
                    and self.plan.num_pages_int8 > self.num_pages:
                if pager.in_use / self.num_pages >= g.int8_pressure:
                    self._degrade_to_int8(clock)

            # ---- arrivals (virtual clock), judged at the front door
            while pending and pending[0].arrival <= clock + 1e-9:
                r = pending.pop(0)
                tr.event("queued", clock, cat="request", slot=slot,
                         rid=r.rid)
                m.count("requests_queued")
                if g is not None and self.paged and self._ladder:
                    pressure = pager.in_use / self.num_pages
                    if "shed" in self._ladder and pressure >= g.shed_pressure:
                        resolve(r, "shed",
                                f"pool pressure {pressure:.2f} >= shed "
                                f"threshold {g.shed_pressure:.2f} at arrival")
                        continue
                    if "clamp_max_new" in self._ladder \
                            and pressure >= g.clamp_pressure \
                            and r.max_new > g.clamp_max_new:
                        r.max_new = g.clamp_max_new
                        r.degraded.append("clamp_max_new")
                        st["clamped_admissions"] += 1
                        m.count("clamped_admissions")
                        tr.event("degrade_rung", clock, cat="degrade",
                                 slot=slot, rid=r.rid,
                                 rung="clamp_max_new")
                waiting.append(r)

            # ---- deadlines: waiting requests, then live rows
            if g is not None:
                for r in list(waiting):
                    dl = deadline_of(r)
                    if dl is not None and clock + 1e-9 >= dl:
                        waiting.remove(r)
                        resolve(r, "expired",
                                f"deadline (arrival {r.arrival:g} + ttl "
                                f"{dl - r.arrival:g} steps) passed before "
                                "admission")
                for row, r in list(active.items()):
                    dl = deadline_of(r)
                    if dl is not None and clock + 1e-9 >= dl:
                        evict_active(row, "expired",
                                     f"deadline (arrival {r.arrival:g} + "
                                     f"ttl {dl - r.arrival:g} steps) passed "
                                     f"mid-generation; {len(r.out)} tokens "
                                     "kept")

            if not active and not waiting:
                if not pending:
                    break
                st["idle_steps"] += pending[0].arrival - clock
                clock = pending[0].arrival
                continue

            # ---- page headroom for the live rows' next chunk, oldest first
            stalled = False
            if self.paged:
                for row in list(admit_order):
                    if row not in active:
                        continue
                    r = active[row]
                    need = min(row_pos[row] + T, self._final_len(r))
                    while row in active and not ensure_pages(r.rid, need):
                        if not preempt_latest():
                            if g is None:
                                raise RuntimeError(
                                    "page pool exhausted with nothing left "
                                    "to preempt: num_pages is too small")
                            stalled = True
                            break
                    if stalled:
                        break
                    if row in active:
                        pager.set_length(r.rid, row_pos[row])
            clear_preempted_flags()
            if stalled:
                note_stall("no page headroom for the next chunk")
                clock += T
                continue

            # ---- admission of arrived requests into free rows
            to_admit: List[StreamRequest] = []
            while waiting and len(to_admit) < alloc.available():
                r = waiting[0]
                if r.rid in just_preempted:
                    break        # evicted this boundary: wait one, keep rank
                if self.paged and not ensure_pages(
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
                    m.count("requests_admitted")
                    wait = clock - r.arrival
                    m.observe("admission_wait_steps", wait)
                    m.tenant_observe(r.tenant, "admission_wait_steps", wait)
                    tr.event("admitted", clock, cat="request", slot=slot,
                             rid=r.rid, shared_tokens=r.shared_tokens)
            if admits:
                buckets: Dict[int, List[Tuple[int, StreamRequest]]] = {}
                for row, r in admits:
                    buckets.setdefault(self.plan.tier(self._plen(r)),
                                       []).append((row, r))
                bt = block_table()
                with telemetry_mod.phase_timer(
                        st, "prefill_s", tracer=tr, name="prefill",
                        start=clock, slot=slot) as ph:
                    for tier, group in sorted(buckets.items()):
                        toks, lengths, slots, budgets = build_tier_batch(
                            group, tier, self._resume_prompt,
                            lambda r: r.max_new - len(r.out))
                        for row, r in group:
                            active[row] = r
                        refill_rows(self.params, self.cfg, self.plan, state,
                                    toks, lengths, slots, budgets,
                                    block_table=bt)
                        B, real = len(group), int(lengths.sum())
                        st["prefill_batches"] += 1
                        st["prefill_prompts"] += B
                        st["prefill_real_tokens"] += real
                        st["prefill_padded_tokens"] += B * tier
                        m.count("prefill_batches")
                        m.count("prefill_prompts", B)
                        m.count("prefill_real_tokens", real)
                        m.count("prefill_padded_tokens", B * tier)
                    ph.ready(state[1])
                    ph.note(prompts=len(admits), tiers=len(buckets))

            if not active:
                if g is not None or inj is not None:
                    # nothing running and nothing admitted (chaos ensure
                    # failures can starve admission): let the clock run on
                    st["idle_steps"] += T
                    clock += T
                continue
            st["peak_live_rows"] = max(st["peak_live_rows"], len(active))
            if self.paged:
                s = pager.stats()
                if peak_pages is None or \
                        s["pages_used"] > peak_pages["pages_used"]:
                    peak_pages = s

            # ---- transient step faults (chaos): retried with backoff
            # before the chunk's device work and any sampler draw, so a
            # retry replays nothing and survivors stay bit-identical
            if inj is not None:
                attempt, aborted = 0, False
                while True:
                    try:
                        inj.check_step(st["decode_chunks"])
                        break
                    except chaos_mod.InjectedFault as e:
                        attempt += 1
                        st["step_retries"] += 1
                        m.count("step_retries")
                        limit = g.max_step_retries if g is not None else 3
                        if attempt > limit:
                            reason = (f"decode step failing persistently "
                                      f"({e}) — {limit} retries spent")
                            for row in list(active):
                                evict_active(row, "failed", reason)
                            for r in list(waiting) + list(pending):
                                resolve(r, "failed", reason)
                            waiting.clear()
                            pending.clear()
                            aborted = True
                            break
                        time.sleep(backoff_delay(
                            attempt, g.backoff_s if g is not None else 0.0))
                if aborted:
                    clear_preempted_flags()
                    continue

            # ---- NaN quarantine: state[1] holds the logits each row samples
            # its next token from; a non-finite row is evicted before the
            # chunk (chaos poisons the same buffer, in place)
            if inj is not None:
                prids = set(inj.nan_rids_for(st["decode_chunks"]))
                prows = [row for row, r in active.items() if r.rid in prids]
                if prows:
                    state[1][torch.as_tensor(prows, device=self.device)] = \
                        float("nan")
            if g is not None and (g.nan_check or inj is not None):
                bad = torch.isnan(state[1]).reshape(self.rows, -1) \
                    .any(dim=1).cpu().numpy()
                self.host_syncs += 1
                for row in [int(i) for i in np.nonzero(bad)[0]
                            if int(i) in active]:
                    r = active[row]
                    evict_active(row, "failed",
                                 "non-finite logits at the sync boundary; "
                                 f"{len(r.out)} tokens kept")
                clear_preempted_flags()
                if not active:
                    st["idle_steps"] += T
                    clock += T
                    continue

            # ---- one decode chunk on the device, one transfer back
            with telemetry_mod.phase_timer(
                    st, "decode_s", tracer=tr, name="decode_chunk",
                    start=clock, end=clock + T, slot=slot) as ph:
                block_table()
                toks_h, emits_h, live_h = self._loop.chunk()
                ph.note(rows=len(active))
            self.host_syncs += 1
            st["decode_chunks"] += 1
            st["decode_steps"] += T
            m.count("decode_chunks")
            m.count("decode_steps", T)
            stall_streak = 0
            clock += T
            # window-end gauges, sampled while the chunk's rows are resident
            m.gauge("queue_pending", len(pending))
            m.gauge("queue_waiting", len(waiting))
            m.gauge("active_rows", len(active))
            if self.paged:
                pager.observe(m)
            m.end_window(clock, slot)
            emitted = 0
            for t in range(T):
                for row, r in active.items():
                    if emits_h[t, row]:
                        tok = int(toks_h[t, row])
                        r.out.append(tok)
                        emitted += 1
                        if r.first_token_at is None:
                            r.first_token_at = clock - T + t + 1
                        if r.on_token is not None:
                            r.on_token(r, tok)
            m.count("tokens_emitted", emitted)
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
                    resolve(r, "ok")
            alloc.free_many(freed_rows)

            if g is not None and g.audit_every_sync and self.paged:
                guard_mod.assert_pool_clean(pager, tracer=tr, clock=clock,
                                            slot=slot)

        st["total_wall_s"] = run_clock.elapsed_s()
        st["clock_steps"] = clock
        m.gauge("clock", clock)
        if g is not None:
            for r in requests:
                if r.outcome is None:       # unreachable by construction
                    if not r.done:
                        r.done = True
                        done.append(r)
                    r.outcome = guard_mod.RequestOutcome(
                        "failed", "run ended without a terminal state",
                        at_step=clock)
            st["outcomes"] = {k: 0 for k in guard_mod.OUTCOMES}
            for r in done:
                st["outcomes"][r.outcome.status] += 1
        if inj is not None:
            st["chaos_injected"] = dict(inj.injected)
        if self.paged:
            st["pages"] = pager.stats()              # drained end state
            st["pages_peak"] = peak_pages            # busiest boundary
            if g is not None:
                guard_mod.assert_pool_clean(pager, drained=True, tracer=tr,
                                            clock=clock, slot=slot)
        if self._own_telemetry or self.slot < 0:
            st["drift"] = tel.detect_drift(self.plan).summary()
        return done
