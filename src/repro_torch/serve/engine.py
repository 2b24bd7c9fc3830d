"""Sampling, prefill tiers, the fused decode step and the drain engine
(counterpart of ``repro.serve.engine``).

The reference's decode loop never leaves the device between refills:
``sync_every`` steps run as one jitted ``lax.scan`` with the state donated,
and the sampled tokens reach the host in one transfer per chunk. The port's
:class:`DecodeLoop` keeps that structure. The decode state lives on
persistent buffers that every step updates in place (``make_step_in_place``);
on the card each step is one replay of a captured CUDA graph
(``serve.graphs.StepGraph``), on the CPU (or with ``graphs=False``) the same
body runs eagerly. :class:`DecodeEngine` (the dense-slot drain engine behind
``LLM.generate``) and the streaming scheduler both decode through it.

The loop also carries the device half of the guard's int8 degradation rung
(:meth:`DecodeLoop.quantize_kv`): the paged pools are requantized in place
of the fp ones mid-run and, on the card, the step graph is captured again
over the new pools without disturbing the live rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.models import decoding
from repro_torch.models import transformer as tfm
from repro_torch.serve import telemetry as telemetry_mod
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.guard import RequestOutcome
from repro_torch.serve.kvcache import SlotAllocator


def resolve_device(device=None) -> torch.device:
    """``device``, defaulting to the card; raises when CUDA is asked for
    (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch serves on the GPU; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def make_serve_step(cfg, plan) -> Callable:
    """(params, cache, tokens, pos[, block_table]) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos, block_table=None):
        return decoding.serve_step(params, cache, tokens, pos, cfg,
                                   plan=plan, block_table=block_table)
    return serve_step


def make_prefill_step(cfg, cache_len: int, plan) -> Callable:
    """(params, tokens (B, S)) -> (last logits, fresh contiguous cache)."""
    def prefill_step(params, tokens):
        return decoding.prefill(params, tokens, cfg, cache_len, plan=plan)
    return prefill_step


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def sample_temperature(logits: torch.Tensor, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """Greedy (the first argmax) at temperature <= 0, else a categorical
    draw from softmax(logits / temperature) with ``generator``."""
    if temperature <= 0:
        return sample_greedy(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_generate_fn(cfg, num_steps: int, temperature: float = 0.0, *,
                     plan) -> Callable:
    """Prefill, then ``num_steps`` decode steps, for (B, S) prompts of one
    length (the reference's ``make_generate_fn``, its scan as a loop).
    Returns generate(params, tokens, generator=None) -> (B, num_steps)."""
    def generate(params, tokens, generator=None):
        prompt_len = tokens.shape[-1]
        logits, cache = decoding.prefill(params, tokens, cfg,
                                         prompt_len + num_steps, plan=plan)
        pos = torch.full((tokens.shape[0],), prompt_len, dtype=torch.long,
                         device=tokens.device)
        out = []
        for _ in range(num_steps):
            nxt = sample_temperature(logits[:, -1], temperature, generator)
            out.append(nxt)
            logits, cache = decoding.serve_step(params, cache, nxt[:, None],
                                                pos, cfg, plan=plan)
            pos = pos + 1
        return torch.stack(out, dim=1)
    return generate


@dataclasses.dataclass
class Request:
    """A drain-engine request; ``out`` collects its tokens."""
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    outcome: Optional[RequestOutcome] = None


def length_tier(plen: int, recurrent: bool, cache_len: int = 0) -> int:
    """Prefill bucket: the next power of two (exact for recurrent archs),
    clamped to ``cache_len`` when given."""
    if recurrent:
        return plen
    tier = 1 << max(plen - 1, 0).bit_length()
    return min(tier, cache_len) if cache_len else tier


def make_decode_step(cfg, plan, temperature: float, eos_id: int) -> Callable:
    """One decode step over every row: sample -> EOS/budget masks ->
    ``serve_step``. carry = (cache, last, pos, live, budget)."""

    def step(params, carry, generator=None, block_table=None):
        cache, last, pos, live, budget = carry
        nxt = sample_temperature(last, temperature, generator)
        emit = live
        budget = budget - emit.to(budget.dtype)
        live = live & (nxt != eos_id) & (budget > 0)
        logits, cache = decoding.serve_step(
            params, cache, nxt[:, None], pos, cfg, plan=plan,
            block_table=block_table)
        return (cache, logits[:, -1], pos + 1, live, budget), (nxt, emit)

    return step


def make_step_in_place(cfg, plan, temperature: float, eos_id: int
                       ) -> Callable:
    """``make_decode_step``'s step with its results written into its
    inputs: body(params, state, nxt, emit, generator, block_table) leaves
    the sampled tokens in ``nxt``, the emit flags in ``emit`` and the new
    last, pos, live and budget in ``state``'s own buffers (the cache is
    written in place by ``serve_step``). The body a StepGraph captures."""
    step = make_decode_step(cfg, plan, temperature, eos_id)

    def body(params, state, nxt, emit, generator=None, block_table=None):
        new, (tok, em) = step(params, state, generator, block_table)
        nxt.copy_(tok)
        emit.copy_(em)             # em is state's live: copy it first
        for buf, value in zip(state[1:], new[1:]):
            buf.copy_(value)

    return body


def build_tier_batch(group, tier: int, prompt_of: Callable,
                     budget_of: Callable):
    """Host arrays for one admission tier: (toks, lengths, slots, budgets).
    ``group`` is [(slot, request), ...]."""
    B = len(group)
    toks = np.zeros((B, tier), np.int32)
    lengths = np.empty((B,), np.int32)
    slot_ids = np.empty((B,), np.int64)
    budgets = np.empty((B,), np.int32)
    for i, (slot, r) in enumerate(group):
        p = prompt_of(r)
        toks[i, :len(p)] = p
        lengths[i] = len(p)
        slot_ids[i] = slot
        budgets[i] = budget_of(r)
    return toks, lengths, slot_ids, budgets


def refill_rows(params, cfg, plan, state, toks, lengths, slots, budgets, *,
                block_table=None) -> None:
    """Batched prefill of one length tier into rows ``slots`` of ``state``,
    in place: paged global K/V straight into the pools through
    ``block_table``'s rows, every other entry merged into its rows."""
    cache, last, pos, live, budget = state
    dev = last.device
    toks = torch.as_tensor(toks, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
    if block_table is not None:
        pp = decoding.PagedPrefill(cache=cache,
                                   block_table_rows=block_table[slots],
                                   slots=slots)
        logits, _ = decoding.prefill_batched(
            params, toks, lengths, cfg, plan.cache_len, plan=plan, paged=pp)
    else:
        logits, rows = decoding.prefill_batched(
            params, toks, lengths, cfg, plan.cache_len, plan=plan)
        for name, entry in cache["blocks"].items():
            for k, t in entry.items():
                t[:, slots] = rows["blocks"][name][k]
    last[slots] = logits[:, -1]
    pos[slots] = lengths.long()
    live[slots] = True
    budget[slots] = torch.as_tensor(budgets, dtype=budget.dtype, device=dev)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


class DecodeLoop:
    """The device side of a decode loop: the decode state on persistent
    buffers, ``sync_every``-step chunks, and one transfer per chunk.

    ``paged`` keeps global K/V in ``plan``'s page pool, read through the
    static ``block_table`` (rows, max_pages) int32 that the caller fills in
    place; otherwise the cache is contiguous (``decoding.init_cache``). On
    the card with ``graphs`` (the default) each step is one replay of a
    :class:`StepGraph`, captured at the first :meth:`start` and reused by
    every later one; on the CPU, or with ``graphs=False``, the same in-place
    body runs eagerly. Either way the buffers are the state: callers write
    new rows into them (``refill_rows``) and never rebind them; only
    :meth:`quantize_kv` swaps the paged pools, inside the same cache dict.
    ``captures`` lists the seconds of every capture this loop made."""

    def __init__(self, cfg, params, plan, *, temperature: float,
                 eos_id: int, device, paged: bool, sync_every: int,
                 graphs: bool = True):
        self.cfg, self.params, self.plan = cfg, params, plan
        self.device = device
        self.paged = paged
        self.rows = plan.rows
        self.sync_every = max(1, sync_every)
        self.temperature = temperature
        self.use_graph = graphs and device.type == "cuda"
        self.body = make_step_in_place(cfg, plan, temperature, eos_id)
        self.generator = torch.Generator(device=device)
        self.state = None
        self.block_table: Optional[torch.Tensor] = None
        self.graph: Optional[StepGraph] = None
        self.captures: List[float] = []

    def _alloc(self) -> None:
        cfg, plan, dev, R, T = (self.cfg, self.plan, self.device, self.rows,
                                self.sync_every)
        if self.paged:
            cache = decoding.init_paged_cache(
                cfg, R, plan.cache_len, plan.num_pages, plan.page_size,
                plan.kv_quant, device=dev)
            self.block_table = torch.full((R, plan.max_pages), -1,
                                          dtype=torch.int32, device=dev)
        else:
            cache = decoding.init_cache(cfg, R, plan.cache_len, device=dev)
        self.state = (cache,
                      torch.zeros((R, cfg.vocab_padded), device=dev),
                      torch.zeros((R,), dtype=torch.long, device=dev),
                      torch.zeros((R,), dtype=torch.bool, device=dev),
                      torch.zeros((R,), dtype=torch.int32, device=dev))
        self.nxt = torch.zeros((R,), dtype=torch.long, device=dev)
        self.emit = torch.zeros((R,), dtype=torch.bool, device=dev)
        self.toks = torch.zeros((T, R), dtype=torch.long, device=dev)
        self.emits = torch.zeros((T, R), dtype=torch.bool, device=dev)

    def _reset(self) -> None:
        for t in _tensors(self.state):
            t.zero_()
        if self.block_table is not None:
            self.block_table.fill_(-1)

    def _capture(self) -> None:
        self.graph = StepGraph(
            self.body, self.params, self.state, self.nxt, self.emit,
            block_table=self.block_table,
            generator=self.generator if self.temperature > 0 else None)
        self.captures.append(self.graph.capture_s)

    def start(self, seed: int = 0):
        """Zeroed state for a new run, the sampler seeded with ``seed``;
        captures the step graph first if this loop has none yet."""
        if self.state is None:
            self._alloc()
        if self.use_graph and self.graph is None:
            self._reset()
            self._capture()
        self._reset()
        self.generator.manual_seed(seed)
        return self.state

    @contextlib.contextmanager
    def _kept(self):
        """Run the block (a capture's warm-up and captured steps) and leave
        the live decode state as it was: every tensor of the state but the
        paged pools is copied aside and written back, as are ``nxt``,
        ``emit``, the block table and the sampler's state; the block table
        reads all -1 meanwhile, so the steps' paged appends write
        nothing."""
        pools = {id(t) for part in self.state[0].values()
                 for e in part.values() if decoding.is_paged_entry(e)
                 for t in e.values()}
        kept = [t for t in _tensors(self.state) if id(t) not in pools]
        kept += [self.nxt, self.emit]
        if self.block_table is not None:
            kept.append(self.block_table)
        saved = [t.clone() for t in kept]
        rng = self.generator.get_state()
        if self.block_table is not None:
            self.block_table.fill_(-1)
        try:
            yield
        finally:
            for t, v in zip(kept, saved):
                t.copy_(v)
            self.generator.set_state(rng)

    def quantize_kv(self, num_pages: int) -> None:
        """The int8 rung on the device: every fp paged entry of the cache
        becomes ``decoding.quantize_paged_entry(entry, num_pages)`` (the
        rings stay as they are) and the fp pools are released. With a step
        graph, the old graph is dropped and a new one is captured over the
        int8 pools with the live rows kept (:meth:`_kept`). The step reads
        each entry's format from the entry itself, so it reads int8 pages
        from here on."""
        recapture = self.graph is not None
        self.graph = None                  # its memory pool goes with it
        for part in self.state[0].values():
            for name, e in list(part.items()):
                if decoding.is_paged_entry(e) \
                        and not decoding.is_quantized_entry(e):
                    part[name] = decoding.quantize_paged_entry(e, num_pages)
        if recapture:
            with self._kept():
                self._capture()

    def set_block_table(self, table: np.ndarray) -> torch.Tensor:
        """Copy a host (rows, max_pages) table into the static buffer."""
        self.block_table.copy_(torch.from_numpy(table))
        return self.block_table

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body(self.params, self.state, self.nxt, self.emit,
                      self.generator, self.block_table)

    def chunk(self):
        """``sync_every`` steps on the device, then one transfer of the
        sampled tokens (T, rows), their emit flags and the live flags."""
        T = self.sync_every
        for t in range(T):
            self.step()
            self.toks[t].copy_(self.nxt)
            self.emits[t].copy_(self.emit)
        host = torch.cat([self.toks, self.emits.long(),
                          self.state[3].long()[None]]).cpu().numpy()
        return host[:T], host[T:2 * T].astype(bool), host[2 * T].astype(bool)


class DecodeEngine:
    """Continuous batching over a fixed slot count with a device-resident
    decode loop (the reference's drain engine).

    Slots hold independent sequences at per-slot positions in a contiguous
    cache. Admission is batched prefill: pending prompts are bucketed into
    the plan's length tiers, each tier prefilled as one batch and written
    into its slots. Between refills ``sync_every`` decode steps run on the
    device (:class:`DecodeLoop`: one graph replay a step on the card), and
    the chunk's tokens come back in one transfer; ``host_syncs`` counts
    those transfers. ``phase_stats`` (reset per run) has the reference's
    keys.

    Construction is plan-driven: pass a ``core.plan.ServePlan``
    (``plan_for_engine`` for explicit slots/cache_len); slots, cache_len,
    sync cadence, tiers and kernel routes come from it. The legacy
    ``slots=``/``cache_len=`` kwargs build the same single-decision plan,
    with a DeprecationWarning. ``telemetry`` (a ``serve.telemetry.
    Telemetry``; the engine's own, reset per run, when None) receives the
    ``prefill`` and ``decode_chunk`` spans on the synthetic clock
    ``decode_chunks x sync_every``, as the reference's engine records them.
    ``params`` must already be
    on ``device`` (``LLM`` puts them there). ``graphs=False`` runs the
    eager step on the card, for comparison."""

    def __init__(self, cfg, params, plan: Optional[plan_lib.ServePlan] = None,
                 *, slots: Optional[int] = None,
                 cache_len: Optional[int] = None, eos_id: int = 1,
                 temperature: float = 0.0, sync_every: Optional[int] = None,
                 telemetry=None, device=None, graphs: bool = True):
        if plan is not None and not (slots is None and cache_len is None):
            raise TypeError(
                "pass either plan= or the legacy slots=/cache_len= kwargs, "
                "not both (the plan already fixes the geometry)")
        if plan is None:
            if slots is None or cache_len is None:
                raise TypeError(
                    "DecodeEngine needs a ServePlan (core.plan."
                    "plan_for_engine) or the legacy slots=/cache_len= kwargs")
            warnings.warn(
                "constructing DecodeEngine from slots=/cache_len= kwargs is "
                "deprecated: pass plan=core.plan.plan_for_engine(...) or "
                "serve through repro_torch.serve.LLM",
                DeprecationWarning, stacklevel=2)
            plan = plan_lib.plan_for_engine(
                cfg, slots=slots, cache_len=cache_len,
                sync_every=8 if sync_every is None else sync_every)
        if plan.rows < 1:
            raise ValueError(f"slots must be >= 1, got {plan.rows}")
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.slots = plan.rows
        self.cache_len = plan.cache_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.sync_every = max(1, plan.sync_every if sync_every is None
                              else sync_every)
        self.device = resolve_device(device)
        self.host_syncs = 0                  # device->host fetches (per chunk)
        self.phase_stats: Dict = {}
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_mod.Telemetry()
        self._own_telemetry = telemetry is None
        self._loop = DecodeLoop(cfg, params, plan, temperature=temperature,
                                eos_id=eos_id, device=self.device,
                                paged=False, sync_every=self.sync_every,
                                graphs=graphs)

    @property
    def graph(self) -> Optional[StepGraph]:
        """The captured decode step (None on the CPU, with graphs=False,
        or before the first run)."""
        return self._loop.graph

    def run(self, requests: List[Request], seed: int = 0) -> List[Request]:
        """Drain ``requests``; returns them in finishing order. ``seed``
        seeds the sampler (unused when greedy)."""
        queue = list(requests)
        done: List[Request] = []
        for r in [r for r in queue if r.max_new <= 0]:
            queue.remove(r)
            r.done = True
            r.outcome = RequestOutcome("ok", "empty generation budget")
            done.append(r)
        alloc = SlotAllocator(self.slots)
        active: Dict[int, Request] = {}
        state = self._loop.start(seed)
        st = self.phase_stats = {
            "prefill_s": 0.0, "decode_s": 0.0, "prefill_batches": 0,
            "prefill_prompts": 0, "prefill_real_tokens": 0,
            "prefill_padded_tokens": 0, "decode_chunks": 0,
        }
        if self._own_telemetry:
            self.telemetry.reset()
        tr = self.telemetry.tracer
        T = self.sync_every
        while queue or active:
            admits: List[Tuple[int, Request]] = []
            while queue and alloc.available():
                r = queue[0]
                if len(r.prompt) + r.max_new > self.cache_len:
                    raise ValueError(
                        f"request {r.rid}: prompt ({len(r.prompt)}) + "
                        f"max_new ({r.max_new}) exceeds cache_len "
                        f"({self.cache_len})")
                queue.pop(0)
                admits.append((alloc.alloc(), r))
            if admits:
                buckets: Dict[int, List[Tuple[int, Request]]] = {}
                for slot, r in admits:
                    buckets.setdefault(self.plan.tier(len(r.prompt)),
                                       []).append((slot, r))
                with telemetry_mod.phase_timer(
                        st, "prefill_s", tracer=tr, name="prefill",
                        start=st["decode_chunks"] * T) as ph:
                    for tier, group in sorted(buckets.items()):
                        toks, lengths, slot_ids, max_news = build_tier_batch(
                            group, tier, lambda r: r.prompt,
                            lambda r: r.max_new)
                        for slot, r in group:
                            active[slot] = r
                        refill_rows(self.params, self.cfg, self.plan, state,
                                    toks, lengths, slot_ids, max_news)
                        st["prefill_batches"] += 1
                        st["prefill_prompts"] += len(group)
                        st["prefill_real_tokens"] += int(lengths.sum())
                        st["prefill_padded_tokens"] += len(group) * tier
                    ph.ready(state[1])
                    ph.note(prompts=len(admits), tiers=len(buckets))

            with telemetry_mod.phase_timer(
                    st, "decode_s", tracer=tr, name="decode_chunk",
                    start=st["decode_chunks"] * T,
                    end=(st["decode_chunks"] + 1) * T) as ph:
                toks_h, emits_h, live_h = self._loop.chunk()
                ph.note(rows=len(active))
            self.host_syncs += 1
            st["decode_chunks"] += 1
            for t in range(emits_h.shape[0]):
                for slot, r in active.items():
                    if emits_h[t, slot]:
                        r.out.append(int(toks_h[t, slot]))
            for slot in list(active):
                if not live_h[slot]:
                    r = active.pop(slot)
                    r.done = True
                    r.outcome = RequestOutcome("ok")
                    done.append(r)
                    alloc.free(slot)
        return done
