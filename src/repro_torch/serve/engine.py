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
``LLM.generate``), the streaming scheduler and ``make_generate_fn`` (the
reference's one-program prefill and decode) all decode through it.

Under a plan with ``spec_k`` >= 2 the loop's step is one round of greedy
speculative decoding (``make_spec_decode_step``): k candidates drafted from
each row's own token history by bigram lookup (``ngram_successor``), scored
by one flattened k-position verify (``decoding.verify_step``), and the
prefix that greedy decoding would have produced emitted. On the card a round
is one graph replay, as a plain step is.

The loop also carries the device half of the guard's int8 degradation rung
(:meth:`DecodeLoop.quantize_kv`): the paged pools are requantized in place
of the fp ones mid-run and, on the card, the step graph is captured again
over the new pools (as a plain step: int8 pools never speculate) without
disturbing the live rows. The device halves of copy-on-write
(:meth:`DecodeLoop.copy_pages`) and of the scheduler's suffix-only resume
(``resume_suffix``) run between chunks, eagerly, on the same buffers.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.models import decoding
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


def serving_refusal(cfg) -> Optional[str]:
    """Why the serving loops (``LLM.stream`` and ``LLM.generate``,
    ``DecodeEngine``, ``ContinuousBatchingScheduler``) do not serve
    ``cfg``, or None when they do. They serve one-codebook text decoders:
    their refill prefills batches of (rows, tokens) prompts with no vision
    patches and no conditioning, as the reference's loops do (its
    ``prefill_batched`` asserts there are no patches, and its refill
    passes no ``cond``)."""
    what = [w for w, on in (
        (f"{cfg.num_patches} vision patches", cfg.frontend == "vision"),
        (f"an {cfg.frontend} frontend", cfg.frontend not in ("none",
                                                             "vision")),
        ("cross-attention to a conditioning sequence",
         bool(cfg.cross_attn_cond)),
        (f"{cfg.num_codebooks} codebooks", cfg.num_codebooks > 1)) if on]
    if not what:
        return None
    return (f"{cfg.name} has {', '.join(what)}: the serving loops "
            "(LLM.stream, LLM.generate, DecodeEngine, the scheduler) do not "
            "serve it, as the reference's do not; serve it through "
            "serve.engine.make_generate_fn (or make_prefill_step and "
            "make_serve_step, or models.decoding.prefill(patch_embeds=, "
            "cond=) and serve_step(cond=))")


def check_servable(cfg) -> None:
    """Raise ``ValueError`` with ``serving_refusal(cfg)`` when there is
    one."""
    why = serving_refusal(cfg)
    if why is not None:
        raise ValueError(why)


def make_serve_step(cfg, plan=None) -> Callable:
    """(params, cache, tokens, pos[, cond, block_table]) -> (logits,
    cache). ``plan`` None routes by the active plan, else by the
    ``core.dataflow`` rules (the reference's plan-less factory)."""
    def serve_step(params, cache, tokens, pos, cond=None, block_table=None):
        return decoding.serve_step(params, cache, tokens, pos, cfg,
                                   plan=plan, block_table=block_table,
                                   cond=cond)
    return serve_step


def make_prefill_step(cfg, cache_len: int, plan=None) -> Callable:
    """(params, tokens (B, S) or (B, K, S)[, patch_embeds, cond]) -> (last
    logits, fresh contiguous cache); ``plan`` as in ``make_serve_step``."""
    def prefill_step(params, tokens, patch_embeds=None, cond=None):
        return decoding.prefill(params, tokens, cfg, cache_len, plan=plan,
                                patch_embeds=patch_embeds, cond=cond)
    return prefill_step


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def sample_temperature(logits: torch.Tensor, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """Greedy (the first argmax) at temperature <= 0, else a categorical
    draw from softmax(logits / temperature) with ``generator``, one per
    row of the last axis ((B, V) -> (B,), (B, K, V) -> (B, K))."""
    if temperature <= 0:
        return sample_greedy(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                              generator=generator)
    return draws.reshape(logits.shape[:-1])


GENERATE_LOOPS = 4


def make_generate_fn(cfg, num_steps: int, temperature: float = 0.0, *,
                     plan=None, graphs: bool = True,
                     max_loops: int = GENERATE_LOOPS) -> Callable:
    """Prefill, then ``num_steps`` decode steps, for prompts of one length
    (the reference's ``make_generate_fn``, its jitted scan as one captured
    decode step; ``plan`` as in ``make_serve_step``). Returns
    generate(params, tokens, generator=None, patch_embeds=None, cond=None):
    tokens (B, S), or (B, K, S) for K codebooks; a vision config's
    ``cfg.num_patches`` count into the prompt and cache lengths whether or
    not patches (B, P, d) are given, as the reference counts them (without
    patches the first step decodes at position S + P); ``cond`` (B, T, d)
    is read by every step of a config with cross-attention. Returns the
    (B, num_steps) tokens, or (B, num_steps, K), on the tokens' device: at
    K > 1 each codebook is sampled from the last position's (B, K, Vp)
    logits and the (B, K, 1) tokens fed back, as the reference's
    ``make_decode_step`` samples them (its ``make_generate_fn`` indexes
    the codebook axis there and raises).

    The prefill runs as ``decoding.prefill``; its cache, last logits, the
    positions and ``cond`` are then copied onto the fixed buffers of a
    :class:`DecodeLoop` (contiguous, every row live for ``num_steps``
    steps, no EOS, as in the reference's scan), and the steps run as its
    in-place body. On the card each step is one replay of the loop's
    :class:`StepGraph`, captured at the first call of each input shape
    (rows, prompt, patches, ``cond``); nothing is transferred to the host
    between the prefill and the return. On the CPU, or with
    ``graphs=False``, the same body runs eagerly. Sampling draws from
    ``generator`` (the device's default generator when None) through the
    loop's own generator, whose state is copied in before the steps and
    back after them: the draws, and the generator's state after the call,
    are the eager loop's.

    ``generate.loops`` keeps the loops of the ``max_loops`` input shapes
    used last, the oldest released first. Each holds device memory between
    calls: a contiguous cache of (rows, prompt + ``num_steps``) positions,
    ``last``, ``hist``, the step's outputs and, graphed, the graph's memory
    pool. A captured graph reads the params' leaves at their addresses, so
    the loops belong to one set of leaves (the address, shape, stride and
    dtype of each): a call whose params differ in any leaf, in the same
    dict or another, releases every loop first."""
    loops: "collections.OrderedDict[tuple, DecodeLoop]" = \
        collections.OrderedDict()
    held = [None]                  # _leaf_key of the params the loops read

    def generate(params, tokens, generator=None, patch_embeds=None,
                 cond=None):
        leaves = _leaf_key(params)
        if leaves != held[0]:
            for lp in loops.values():
                lp.release()
            loops.clear()
            held[0] = leaves
        patches = cfg.num_patches if cfg.frontend == "vision" else 0
        prompt_len = tokens.shape[-1] + patches
        logits, cache = decoding.prefill(
            params, tokens, cfg, prompt_len + num_steps, plan=plan,
            patch_embeds=patch_embeds, cond=cond)
        key = tuple(None if t is None else tuple(t.shape)
                    for t in (tokens, patch_embeds, cond))
        loop = loops.pop(key, None)
        if loop is None:
            while len(loops) >= max(1, max_loops):
                loops.popitem(last=False)[1].release()
            # allocates only in start()
            loop = DecodeLoop(
                cfg, params, plan, temperature=temperature, eos_id=-1,
                device=tokens.device, paged=False, sync_every=num_steps,
                graphs=graphs, rows=tokens.shape[0],
                cache_len=prompt_len + num_steps,
                cond_len=0 if cond is None else cond.shape[1])
        loops[key] = loop                       # the most recent last
        loop.params = params                    # the same leaves
        state = loop.start()
        _copy_tree(state[0], cache)
        state[1].copy_(logits[:, -1])
        state[2].fill_(prompt_len)
        state[3].fill_(True)
        state[4].fill_(num_steps)
        if cond is not None:
            loop.cond.copy_(cond)
        del logits, cache
        if temperature > 0:
            if generator is None:
                generator = torch.cuda.default_generators[
                    tokens.device.index or 0] \
                    if tokens.device.type == "cuda" \
                    else torch.default_generator
            loop.generator.set_state(generator.get_state())
        loop.steps()
        if temperature > 0:
            generator.set_state(loop.generator.get_state())
        return loop.toks.movedim(0, 1).clone()

    generate.loops = loops
    return generate


def _leaf_key(params) -> tuple:
    """What a captured step reads of ``params``: the address, shape,
    stride and dtype of every leaf, in the tree's order."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in _tensors(params))


def _copy_tree(dst, src) -> None:
    """Copy every leaf of the cache tree ``src`` into ``dst``'s, which must
    have the same keys, shapes and dtypes."""
    for key, t in src.items():
        if isinstance(t, dict):
            _copy_tree(dst[key], t)
        elif dst[key].shape != t.shape or dst[key].dtype != t.dtype:
            raise ValueError(f"cache leaf {key}: {tuple(t.shape)} {t.dtype} "
                             f"does not fit {tuple(dst[key].shape)} "
                             f"{dst[key].dtype}")
        else:
            dst[key].copy_(t)


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


def make_decode_step(cfg, temperature: float, eos_id: int,
                     plan=None) -> Callable:
    """One decode step over every row: sample -> EOS/budget masks ->
    ``serve_step`` (``plan`` as in ``make_serve_step``). carry = (cache,
    last, pos, live, budget[, hist]); a draft history rides along
    untouched. ``last`` is (B, V), or (B, K, V) for K codebooks: each
    codebook is sampled, the first carries EOS, and the (B, K, 1) tokens
    are fed back, as the reference's step does. ``cond`` is passed on to
    ``serve_step`` (the reference's step takes none, so it cannot run a
    config with cross-attention)."""
    K = cfg.num_codebooks

    def step(params, carry, generator=None, block_table=None, cond=None):
        cache, last, pos, live, budget = carry[:5]
        nxt = sample_temperature(last, temperature, generator)
        head = nxt[:, 0] if K > 1 else nxt
        emit = live
        budget = budget - emit.to(budget.dtype)
        live = live & (head != eos_id) & (budget > 0)
        logits, cache = decoding.serve_step(
            params, cache, nxt[..., None], pos, cfg, plan=plan,
            block_table=block_table, cond=cond)
        return (cache, logits[:, -1], pos + 1, live, budget) \
            + tuple(carry[5:]), (nxt, emit)

    return step


def ngram_successor(hist, pos, tok):
    """The bigram self-draft: for each row, the token that followed the
    most recent earlier occurrence of ``tok`` in its history, or ``tok``
    itself when it never occurred. ``hist`` (B, H) holds each row's tokens
    by position, ``pos`` (B,) how many of them are committed: only a
    successor at j + 1 < pos is read, so the draft depends on the committed
    stream alone (a rejected draft's leftovers past pos are never seen)."""
    H = hist.shape[1]
    idx = torch.arange(H, device=hist.device)
    match = (hist == tok[:, None].to(hist.dtype)) \
        & (idx[None, :] + 1 < pos[:, None])
    j = torch.where(match, idx[None, :], -1).amax(dim=1)
    nxt = torch.gather(hist, 1, (j + 1).clamp(0, H - 1)[:, None])[:, 0]
    return torch.where(j >= 0, nxt.to(tok.dtype), tok)


def make_spec_decode_step(cfg, plan, eos_id: int, k: int) -> Callable:
    """One round of greedy speculative decoding over every row (the
    reference's ``make_spec_decode_step``): draft k candidates (the argmax
    of ``last``, then k - 1 bigram successors), score them with one
    ``decoding.verify_step``, and emit the prefix greedy decoding would
    produce: candidate i + 1 only while it equals the verifier's argmax
    after candidates 0..i, stopping at the first EOS and at the row's
    budget. A row emits n in [1, k] tokens a round (0 when dead); ``pos``
    advances by n, ``last`` becomes the verifier's logits after the last
    emitted token, and all k candidates go into ``hist`` at pos..pos+k-1
    (the rejected tail lies past the new pos, where the next round writes
    over it and no read looks). carry = (cache, last, pos, live, budget,
    hist); returns (carry, (candidates (B, k), emit flags (B, k))).
    ``cond`` is passed on to ``verify_step``."""
    if k < 2:
        raise ValueError(f"spec k must be >= 2, got {k}")

    def step(params, carry, generator=None, block_table=None, cond=None):
        cache, last, pos, live, budget, hist = carry
        B, dev = last.shape[0], last.device
        cands = [torch.argmax(last, dim=-1)]
        for _ in range(k - 1):
            cands.append(ngram_successor(hist, pos, cands[-1]))
        v = torch.stack(cands, dim=1)                             # (B, k)
        logits, cache = decoding.verify_step(params, cache, v, pos, cfg,
                                             plan=plan,
                                             block_table=block_table,
                                             cond=cond)
        g = torch.argmax(logits, dim=-1)
        first = torch.ones((B, 1), dtype=torch.bool, device=dev)
        ok = torch.cat([first, v[:, 1:] == g[:, :-1]], dim=1)
        acc = torch.cumprod(ok.int(), dim=1).bool()
        not_eos = v != eos_id
        no_prior_eos = torch.cat(
            [first, torch.cumprod(not_eos[:, :-1].int(), dim=1).bool()],
            dim=1)
        steps = torch.arange(k, device=dev)[None, :]
        emit = live[:, None] & acc & no_prior_eos \
            & (budget[:, None] > steps)
        n = emit.sum(dim=1)
        budget = budget - n.to(budget.dtype)
        new_live = live & ~(emit & ~not_eos).any(dim=1) & (budget > 0)
        sel = (n - 1).clamp(0, k - 1)
        picked = torch.gather(
            logits, 1, sel[:, None, None].expand(B, 1, logits.shape[-1]))
        last = torch.where(live[:, None], picked[:, 0], last)
        posk = pos[:, None] + steps
        rows = torch.arange(B, device=dev)[:, None].expand(B, k)
        decoding._masked_set(hist, (rows.reshape(-1), posk.reshape(-1)),
                             v.reshape(-1),
                             ((posk < hist.shape[1]) & live[:, None])
                             .reshape(-1))
        return (cache, last, pos + n, new_live, budget, hist), (v, emit)

    return step


def make_step_in_place(cfg, plan, temperature: float, eos_id: int,
                       spec_k: int = 0) -> Callable:
    """The decode step with its results written into its inputs:
    body(params, state, nxt, emit, generator, block_table, cond) leaves the
    sampled tokens in ``nxt``, the emit flags in ``emit`` and the new last,
    pos, live and budget in ``state``'s own buffers (the cache and, in a
    speculative round, ``hist`` are written in place); ``cond`` (B, T, d),
    or None, is read. ``spec_k`` >= 2 makes it a ``make_spec_decode_step``
    round (greedy; ``nxt`` and ``emit`` are then (rows, k)), otherwise a
    ``make_decode_step`` step, which leaves ``hist`` as it is. The body a
    StepGraph captures."""
    step = make_spec_decode_step(cfg, plan, eos_id, spec_k) if spec_k \
        else make_decode_step(cfg, temperature, eos_id, plan)

    def body(params, state, nxt, emit, generator=None, block_table=None,
             cond=None):
        new, (tok, em) = step(params, state, generator, block_table, cond)
        nxt.copy_(tok)
        emit.copy_(em)             # em may be state's live: copy it first
        for buf, value in zip(state[1:5], new[1:5]):
            buf.copy_(value)

    return body


def build_tier_batch(group, tier: int, prompt_of: Callable,
                     budget_of: Callable, start_of: Optional[Callable] = None):
    """Host arrays for one admission tier: (toks, lengths, slots, budgets,
    starts). ``group`` is [(slot, request), ...]; ``start_of`` gives the
    first prompt token the prefill writes (past a shared prefix; default
    0)."""
    B = len(group)
    toks = np.zeros((B, tier), np.int32)
    lengths = np.empty((B,), np.int32)
    slot_ids = np.empty((B,), np.int64)
    budgets = np.empty((B,), np.int32)
    starts = np.zeros((B,), np.int32)
    for i, (slot, r) in enumerate(group):
        p = prompt_of(r)
        toks[i, :len(p)] = p
        lengths[i] = len(p)
        slot_ids[i] = slot
        budgets[i] = budget_of(r)
        if start_of is not None:
            starts[i] = start_of(r)
    return toks, lengths, slot_ids, budgets, starts


def refill_rows(params, cfg, plan, state, toks, lengths, slots, budgets, *,
                block_table=None, starts=None) -> None:
    """Batched prefill of one length tier into rows ``slots`` of ``state``,
    in place: paged global K/V straight into the pools through
    ``block_table``'s rows from ``starts`` on (tokens before it sit in
    adopted shared pages), every other entry merged into its rows; each
    row's draft history is the prompt."""
    cache, last, pos, live, budget, hist = state
    dev = last.device
    toks = torch.as_tensor(toks, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
    if block_table is not None:
        pp = decoding.PagedPrefill(
            cache=cache, block_table_rows=block_table[slots], slots=slots,
            write_start=None if starts is None
            else torch.as_tensor(starts, device=dev))
        logits, _ = decoding.prefill_batched(
            params, toks, lengths, cfg, plan.cache_len, plan=plan, paged=pp)
    else:
        logits, rows = decoding.prefill_batched(
            params, toks, lengths, cfg, plan.cache_len, plan=plan)
        # every leaf of every row's entries (a recurrent layer's window and
        # state too), stacked entries on their period axis
        for part, entries in rows.items():
            for name, entry in entries.items():
                for k, t in cache[part][name].items():
                    if part == "blocks":
                        t[:, slots] = entry[k]
                    else:
                        t[slots] = entry[k]
    last[slots] = logits[:, -1]
    pos[slots] = lengths.long()
    live[slots] = True
    budget[slots] = torch.as_tensor(budgets, dtype=budget.dtype, device=dev)
    S = toks.shape[1]
    hist[slots] = -1
    hist[slots, :S] = torch.where(
        torch.arange(S, device=dev)[None, :] < lengths[:, None],
        toks.to(hist.dtype), -1)


def resume_suffix(params, cfg, plan, state, prompt: List[int], start: int,
                  row: int, budget: int, *, block_table) -> None:
    """The suffix-only refill of a preempted request re-admitted on its
    resident prefix pages (the reference's ``_make_resume_fn``): the pages
    hold K/V for ``prompt[:start]``, so only ``prompt[start:]``, padded to
    a power of two, goes through one ``decoding.verify_step`` over that
    many virtual rows. Pad positions write past the committed length (into
    the row's own fresh pages, which decode overwrites before any read)
    and their logits are never read. Row ``row`` of ``state`` is set live
    at ``len(prompt)`` with ``budget`` tokens to go."""
    cache, last, pos, live, budget_t, hist = state
    dev = last.device
    suffix = prompt[start:]
    Lp = 1 << (len(suffix) - 1).bit_length()
    toks = torch.as_tensor([suffix + [0] * (Lp - len(suffix))], device=dev)
    logits, _ = decoding.verify_step(
        params, cache, toks, torch.as_tensor([start], device=dev), cfg,
        plan=plan, block_table=block_table[row:row + 1])
    last[row] = logits[0, len(suffix) - 1]
    pos[row] = len(prompt)
    live[row] = True
    budget_t[row] = budget
    hist[row] = -1
    hist[row, :len(prompt)] = torch.as_tensor(prompt, dtype=hist.dtype,
                                              device=dev)


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

    The state is (cache, last, pos, live, budget, hist): ``hist`` (rows,
    cache_len) int32 holds each row's tokens by position (-1 where none),
    the speculative draft's source. ``paged`` keeps global K/V in
    ``plan``'s page pool, read through the static ``block_table`` (rows,
    max_pages) int32 that the caller fills in place; otherwise the cache is
    contiguous (``decoding.init_cache``). ``spec_k`` >= 2 makes each step a
    speculative round of k candidates (greedy, paged fp only), whose tokens
    and emit flags come back as (T, rows, k). On the card with ``graphs``
    (the default) each step is one replay of a :class:`StepGraph`, captured
    at the first :meth:`start` and reused by every later one; on the CPU, or
    with ``graphs=False``, the same in-place body runs eagerly. Either way
    the buffers are the state: callers write new rows into them
    (``refill_rows``, ``resume_suffix``, :meth:`copy_pages`) and never
    rebind them; only :meth:`quantize_kv` swaps the paged pools, inside the
    same cache dict. ``captures`` lists the seconds of every capture this
    loop made.

    ``rows`` and ``cache_len`` default to the plan's (``plan`` may be None
    when both are given: the step then routes as ``make_serve_step``'s
    plan-less one does). ``cond_len`` > 0 gives the loop a fixed ``cond``
    buffer (rows, cond_len, d) bf16 that every step reads (a config with
    cross-attention). At K = ``cfg.num_codebooks`` > 1, ``last`` is (rows,
    K, Vp) and ``nxt`` (rows, K)."""

    def __init__(self, cfg, params, plan, *, temperature: float,
                 eos_id: int, device, paged: bool, sync_every: int,
                 graphs: bool = True, spec_k: int = 0,
                 rows: Optional[int] = None, cache_len: Optional[int] = None,
                 cond_len: int = 0):
        self.cfg, self.params, self.plan = cfg, params, plan
        self.device = device
        self.paged = paged
        self.rows = plan.rows if rows is None else rows
        self.cache_len = plan.cache_len if cache_len is None else cache_len
        self.cond_len = cond_len
        self.sync_every = max(1, sync_every)
        self.temperature = temperature
        self.eos_id = eos_id
        self.spec_k = spec_k
        # the pool's format and size: the plan's until quantize_kv
        self.kv_quant, self.num_pages = (plan.kv_quant, plan.num_pages) \
            if plan is not None else ("fp", 0)
        self.use_graph = graphs and device.type == "cuda"
        self.body = make_step_in_place(cfg, plan, temperature, eos_id,
                                       spec_k)
        self.generator = torch.Generator(device=device)
        self.state = None
        self.block_table: Optional[torch.Tensor] = None
        self.cond: Optional[torch.Tensor] = None
        self.nxt = self.emit = self.toks = self.emits = None
        self.graph: Optional[StepGraph] = None
        self.captures: List[float] = []

    def _alloc_outputs(self) -> None:
        """``nxt`` (rows[, k or K]), ``emit`` (rows[, k]) and the chunk's
        (T, ...) of each."""
        dev, R, T = self.device, self.rows, self.sync_every
        K = self.cfg.num_codebooks
        emit = (R, self.spec_k) if self.spec_k else (R,)
        tok = (R, K) if K > 1 and not self.spec_k else emit
        self.nxt = torch.zeros(tok, dtype=torch.long, device=dev)
        self.emit = torch.zeros(emit, dtype=torch.bool, device=dev)
        self.toks = torch.zeros((T,) + tok, dtype=torch.long, device=dev)
        self.emits = torch.zeros((T,) + emit, dtype=torch.bool, device=dev)

    def _alloc(self) -> None:
        cfg, plan, dev, R = self.cfg, self.plan, self.device, self.rows
        if self.paged:
            cache = decoding.init_paged_cache(
                cfg, R, self.cache_len, self.num_pages, plan.page_size,
                self.kv_quant, device=dev)
            self.block_table = torch.full((R, plan.max_pages), -1,
                                          dtype=torch.int32, device=dev)
        else:
            cache = decoding.init_cache(cfg, R, self.cache_len, device=dev)
        books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
        self.state = (cache,
                      torch.zeros((R,) + books + (cfg.vocab_padded,),
                                  device=dev),
                      torch.zeros((R,), dtype=torch.long, device=dev),
                      torch.zeros((R,), dtype=torch.bool, device=dev),
                      torch.zeros((R,), dtype=torch.int32, device=dev),
                      torch.full((R, self.cache_len), -1, dtype=torch.int32,
                                 device=dev))
        if self.cond_len:
            self.cond = torch.zeros((R, self.cond_len, cfg.d_model),
                                    dtype=decoding.COMPUTE_DTYPE, device=dev)
        self._alloc_outputs()

    def _reset(self) -> None:
        for t in _tensors(self.state):
            t.zero_()
        self.state[5].fill_(-1)
        if self.block_table is not None:
            self.block_table.fill_(-1)
        if self.cond is not None:
            self.cond.zero_()

    def _capture(self) -> None:
        self.graph = StepGraph(
            self.body, self.params, self.state, self.nxt, self.emit,
            block_table=self.block_table,
            generator=self.generator if self.temperature > 0 else None,
            cond=self.cond)
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
        paged pools is copied aside and written back (``hist`` among them),
        as are ``nxt``, ``emit``, the block table and the sampler's state;
        the block table reads all -1 meanwhile, so the steps' paged appends
        write nothing."""
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
        rings stay as they are) and the fp pools are released. Speculation
        ends here (an int8 append requantizes its whole page, so a rejected
        draft's tokens would move the committed ones' scales): the step
        becomes a plain one. With a step graph, the old graph is dropped and
        a new one is captured over the int8 pools with the live rows kept
        (:meth:`_kept`). The step reads each entry's format from the entry
        itself, so it reads int8 pages from here on."""
        recapture = self.graph is not None
        self.graph = None                  # its memory pool goes with it
        self.kv_quant, self.num_pages = "int8", num_pages
        for part in self.state[0].values():
            for name, e in list(part.items()):
                if decoding.is_paged_entry(e) \
                        and not decoding.is_quantized_entry(e):
                    part[name] = decoding.quantize_paged_entry(e, num_pages)
        if self.spec_k:
            self.spec_k = 0
            self.body = make_step_in_place(self.cfg, self.plan,
                                           self.temperature, self.eos_id)
            self._alloc_outputs()
        if recapture:
            with self._kept():
                self._capture()

    def release(self) -> None:
        """Drop the device memory this loop holds: the decode state (paged
        pools included), the block table, ``cond``, the step's outputs and
        the step graph with its memory pool. The next :meth:`start`
        allocates (and captures) anew, on the pool format of the last
        one."""
        self.graph = None
        self.state = self.block_table = self.cond = None
        self.nxt = self.emit = self.toks = self.emits = None

    def device_bytes(self) -> int:
        """Bytes of the tensors this loop holds (decode state and pools,
        block table, ``cond``, the step's outputs); 0 once released. A step
        graph's intermediates live in its private memory pool, which is not
        counted here."""
        held = list(_tensors(self.state)) if self.state is not None else []
        held += [t for t in (self.block_table, self.cond, self.nxt,
                             self.emit, self.toks, self.emits)
                 if t is not None]
        return sum(t.numel() * t.element_size() for t in held)

    def copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Copy-on-write on the device: physical pages ``src`` (payload and
        int8 scales) copied onto ``dst`` in every paged entry, in place on
        the pools the step graph reads. Between chunks, never inside one."""
        dev = self.device
        s = torch.as_tensor(src, dtype=torch.long, device=dev)
        d = torch.as_tensor(dst, dtype=torch.long, device=dev)
        for part, entries in self.state[0].items():
            for e in entries.values():
                if decoding.is_paged_entry(e):
                    for t in e.values():   # (periods, P, ...) or (P, ...)
                        if part == "blocks":
                            t[:, d] = t[:, s]
                        else:
                            t[d] = t[s]

    def set_block_table(self, table: np.ndarray) -> torch.Tensor:
        """Copy a host (rows, max_pages) table into the static buffer."""
        self.block_table.copy_(torch.from_numpy(table))
        return self.block_table

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body(self.params, self.state, self.nxt, self.emit,
                      self.generator, self.block_table, self.cond)

    def steps(self) -> None:
        """``sync_every`` steps on the device, each one's tokens and emit
        flags written into row t of ``toks`` and ``emits``; nothing leaves
        the device."""
        for t in range(self.sync_every):
            self.step()
            self.toks[t].copy_(self.nxt)
            self.emits[t].copy_(self.emit)

    def chunk(self):
        """:meth:`steps`, then one transfer of the sampled tokens (T, rows)
        or, speculating, the candidates (T, rows, k), their emit flags and
        the live flags."""
        self.steps()
        n, m = self.toks.numel(), self.emits.numel()
        host = torch.cat([self.toks.reshape(-1), self.emits.reshape(-1).long(),
                          self.state[3].long()]).cpu().numpy()
        return (host[:n].reshape(self.toks.shape),
                host[n:n + m].reshape(self.emits.shape).astype(bool),
                host[n + m:].astype(bool))


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
    (``plan_for_engine`` for explicit slots/cache_len; a sharded plan
    raises ``ValueError``, as the reference's drain engine is
    single-device); slots, cache_len,
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
        if plan.sharded:
            raise ValueError("mesh sharding serves through the streaming "
                             "scheduler — the drain engine is single-device")
        check_servable(cfg)
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
                        toks, lengths, slot_ids, max_news, _ = \
                            build_tier_batch(group, tier, lambda r: r.prompt,
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
