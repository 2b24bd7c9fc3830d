"""Sampling, prefill tiers and the fused decode step (the parts of
``repro.serve.engine`` that the streaming scheduler runs)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import decoding


def sample_temperature(logits: torch.Tensor, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """Greedy (the first argmax) at temperature <= 0, else a categorical
    draw from softmax(logits / temperature) with ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
