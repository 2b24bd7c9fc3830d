"""KV and recurrent-state caches, single-token decode and batched prefill
for global, sliding-window (local) and chunked attention, RG-LRU and
Mamba-2 SSD layers, each followed by a dense or MoE MLP (counterpart of
``repro.models.decoding``). The frontend configs' inputs come in beside
the tokens: vision patch embeddings prepended by ``prefill``, and the
conditioning sequence (``cond``) that every attention layer of a config
with cross-attention reads after its self-attention.

Caches keep the reference's layout: entries of the stacked layers sit on a
leading period axis (``cache["blocks"]["slot{j}"]``, one per slot of the
layer pattern), remainder layers' entries unstacked in
``cache["rem"]["rem{j}"]``. A recurrent entry is per-row state: an RG-LRU
layer's ``conv`` window (rows, 3, lru_width) bf16 and ``h`` (rows,
lru_width) fp32, an SSD layer's ``conv`` window (rows, K-1, channels) bf16
and ``ssd`` (rows, heads, state, head_dim) fp32. Its prefill must see
every prompt position and nothing past it, so a recurrent config prefills
exact lengths only. A global entry is either a contiguous ``(periods, rows,
cache_len, KV, D)`` K/V or a paged one, ``(periods, num_pages, page_size,
KV, D)`` pools (``pk``, ``pv``) plus, in the int8 format, ``(periods,
num_pages, KV)`` fp32 amax scales. A local entry is a per-row bf16 ring of
``min(window, cache_len)`` slots in both layouts (a chunked one of
``min(chunk_size, cache_len)``): slot ``i`` holds the token at the largest
position ``p = i (mod cap)`` with ``p <= pos``, and validity is recomputed
from ``pos`` at every step.

Unlike the reference, which returns new caches, every function here writes
the cache it is given in place and returns it (a recurrent layer's decode
copies its new state into the entry's own tensors): the pools are the largest
tensors of a serving run and are never copied. Writes that the reference
drops (positions past a row's length, table entries of -1) are masked here
without reading anything back to the host, so a decode chunk stays free of
device-to-host transfers.

Under a plan with tp > 1 (``core.plan.mesh_degrees``: the given plan, else
the active one) a decode step runs every attention layer over tp KV-head
shards, and with ep > 1 the MoE experts over ep expert shards
(``sharding.tensor_parallel``); the result is the one-device result bit
for bit. Prefill attention is not sharded, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import dataflow
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import ops
from repro_torch.models import layers, rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE, rms_norm
from repro_torch.sharding import tensor_parallel

RECURRENT_KINDS = ("ssm", "rglru")


# ------------------------------------------------------------------ caches
def _attn_cache_capacity(cfg, kind: str, cache_len: int) -> int:
    if kind == "local":
        return min(cfg.window_size, cache_len)
    if kind == "chunked":
        return min(cfg.chunk_size, cache_len)
    return cache_len


def _init_entry(cfg, kind: str, rows: int, cache_len: int, device,
                lead=()):
    """Per-row state of one layer (``lead`` stacks it): bf16 K/V of
    (rows, cap, KV, D) for attention, the recurrent block's state else."""
    if kind == "ssm":
        return ssm_lib.init_ssm_state(rows, cfg, device, lead)
    if kind == "rglru":
        return rglru_lib.init_rglru_state(rows, cfg, device, lead)
    shape = tuple(lead) + (rows, _attn_cache_capacity(cfg, kind, cache_len),
                           cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def _cache_tree(cfg, entry) -> Dict:
    """``{"blocks": {slot: entry(kind, (periods,))}, "rem": {rem:
    entry(kind, ())}}``, each part only when the config has its layers."""
    cache = {}
    if tfm.num_scan_periods(cfg):
        cache["blocks"] = {name: entry(kind, (tfm.num_scan_periods(cfg),))
                           for name, kind in tfm.slot_names(cfg)}
    if tfm.num_remainder(cfg):
        cache["rem"] = {name: entry(kind, ())
                        for name, kind in tfm.rem_names(cfg)}
    return cache


def init_cache(cfg, batch: int, cache_len: int, device=None) -> Dict:
    """Contiguous K/V for global layers, rings for local ones, per-row
    state for recurrent ones."""
    return _cache_tree(cfg, lambda kind, lead: _init_entry(
        cfg, kind, batch, cache_len, device, lead))


def abstract_cache(cfg, batch: int, cache_len: int) -> Dict:
    """``init_cache`` on the ``meta`` device: every leaf's shape and dtype,
    no memory (the reference's ``jax.eval_shape`` of ``init_cache``)."""
    return init_cache(cfg, batch, cache_len, device="meta")


def _init_paged_entry(cfg, num_pages: int, page_size: int, kv_quant: str,
                      device, lead=()):
    shape = tuple(lead) + (num_pages, page_size, cfg.num_kv_heads,
                           cfg.head_dim)
    if kv_quant == "int8":
        sshape = tuple(lead) + (num_pages, cfg.num_kv_heads)
        return {"pk": torch.zeros(shape, dtype=torch.int8, device=device),
                "pv": torch.zeros(shape, dtype=torch.int8, device=device),
                "pk_scale": torch.zeros(sshape, device=device),
                "pv_scale": torch.zeros(sshape, device=device)}
    return {"pk": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "pv": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def init_paged_cache(cfg, rows: int, cache_len: int, num_pages: int,
                     page_size: Optional[int] = None,
                     kv_quant: Optional[str] = None, device=None) -> Dict:
    """Global layers as (num_pages, page_size, KV, D) pools (stacked on the
    period axis), bf16 or int8 with per-(page, KV head) fp32 scales; local
    layers keep their per-row rings and recurrent ones their per-row state,
    whose memory never grows with the context. ``page_size`` and
    ``kv_quant`` default to the active plan's, else to the
    ``core.dataflow`` page clamped to the cache and fp, as the reference
    defaults them."""
    if page_size is None:
        page_size = plan_lib.page_size_default(cache_len)
    if kv_quant is None:
        pl = plan_lib.active_plan()
        kv_quant = pl.kv_quant if pl is not None else "fp"
    if kv_quant not in dataflow.KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {dataflow.KV_QUANT_DTYPES}")
    return _cache_tree(cfg, lambda kind, lead: _init_paged_entry(
        cfg, num_pages, page_size, kv_quant, device, lead)
        if kind == "global" else _init_entry(cfg, kind, rows, cache_len,
                                             device, lead))


def is_recurrent(cfg) -> bool:
    """Whether any layer carries recurrent state (ssm, rglru)."""
    return any(k in RECURRENT_KINDS for k, _ in tfm.slot_kinds(cfg))


def is_paged_entry(entry) -> bool:
    return isinstance(entry, dict) and "pk" in entry


def is_quantized_entry(entry) -> bool:
    return isinstance(entry, dict) and "pk_scale" in entry


# ---------------------------------------------------------- masked writes
def _masked_set(target: torch.Tensor, idx, values: torch.Tensor,
                valid: torch.Tensor) -> None:
    """``target[idx][valid] = values[valid]`` with no host round trip.

    ``idx`` is a tuple of (N,) index tensors, ``values`` (N, ...), ``valid``
    (N,) bool. Invalid entries repeat the first valid entry's write (same
    place, same value, so the scatter stays deterministic); when none is
    valid, every entry rewrites ``target[0, ..., 0]`` with its own value.
    """
    n = valid.numel()
    first = torch.argmax(valid.to(torch.int32))
    any_valid = valid.any()
    sel = torch.where(valid, torch.arange(n, device=valid.device), first)
    idx = tuple(torch.where(any_valid, i[sel].long(), 0) for i in idx)
    vals = values[sel].to(target.dtype)
    target[idx] = torch.where(any_valid, vals, target[idx])


# ------------------------------------------------------ int8 page format
def quantize_to_i8(x, scale):
    """Symmetric int8: round(x / scale * 127), a zero scale giving zeros."""
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x.float() / s * 127.0)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def dequantize_i8(q, scale):
    """int8 payload -> fp32 value, q · (scale · (1 / 127)) in the
    reference's order of operations."""
    return q.float() * (scale * (1.0 / 127.0))


def quantize_paged_entry(entry, num_pages: Optional[int] = None) -> Dict:
    """An fp page pool requantized to the int8 layout (the device half of
    the guard's int8 degradation rung; plain torch, run once per rung).

    Each page gets the per-(page, KV head) amax scale the int8 prefill and
    append paths use, so paged attention and ``_append_token_i8`` read and
    extend the result unchanged. ``num_pages`` above the pool's size grows
    the page axis with zero pages (a zero scale marks an empty page); ids
    0..old-1 keep their contents, so block tables stay valid. Stacked
    ``(periods, P, ps, KV, D)`` and unstacked ``(P, ps, KV, D)`` pools both
    work (the page axis is -4). Converts one leading index at a time, so
    the fp32 temporaries stay one layer's size. Returns a new entry; the
    given one is left as it was."""
    if not is_paged_entry(entry) or is_quantized_entry(entry):
        raise ValueError("quantize_paged_entry takes an fp paged entry")

    def conv(pool):
        P, ps, KV, D = pool.shape[-4:]
        n = P if num_pages is None else max(num_pages, P)
        lead = pool.shape[:-4]
        q = torch.zeros(lead + (n, ps, KV, D), dtype=torch.int8,
                        device=pool.device)
        scale = torch.zeros(lead + (n, KV), device=pool.device)
        src = pool.reshape((-1, P, ps, KV, D))
        qf = q.view((-1, n, ps, KV, D))
        sf = scale.view((-1, n, KV))
        for i in range(src.shape[0]):
            x = src[i].float()
            s = x.abs().amax(dim=(-3, -1))                      # (P, KV)
            qf[i, :P] = quantize_to_i8(x, s[:, None, :, None])
            sf[i, :P] = s
        return q, scale

    pk, ks = conv(entry["pk"])
    pv, vs = conv(entry["pv"])
    return {"pk": pk, "pv": pv, "pk_scale": ks, "pv_scale": vs}


def _token_pages(block_table_rows, lengths, S: int, ps: int, start=None):
    """Physical page, in-page offset and write mask of every (row, token)."""
    B = block_table_rows.shape[0]
    s = torch.arange(S, device=block_table_rows.device)
    page = torch.gather(block_table_rows.long(), 1,
                        (s // ps)[None, :].expand(B, S))
    valid = (s[None, :] < lengths.long()[:, None]) & (page >= 0)
    if start is not None:
        valid &= s[None, :] >= start.long()[:, None]
    return page, (s % ps)[None, :].expand(B, S), valid


def scatter_rows_to_pages(pool, rows_kv, block_table_rows, lengths,
                          start=None):
    """Write per-row KV (B,S,KV,D) into a pool (P,ps,KV,D): token t of row b
    lands at (block_table_rows[b, t // ps], t % ps) for start[b] <= t <
    lengths[b]; pad positions and -1 entries write nothing."""
    B, S = rows_kv.shape[:2]
    page, off, valid = _token_pages(block_table_rows, lengths, S,
                                    pool.shape[1], start)
    _masked_set(pool, (page.reshape(-1), off.reshape(-1)),
                rows_kv.reshape((B * S,) + rows_kv.shape[2:]),
                valid.reshape(-1))
    return pool


def quantize_rows_to_pages(pool, scales, rows_kv, block_table_rows, lengths,
                           start=None):
    """int8 variant of ``scatter_rows_to_pages``: every written (row,
    logical page, KV head) sets that physical page's scale to the amax of
    the tokens written there, then each token is quantized with it."""
    P, ps, KV, D = pool.shape
    B, S = rows_kv.shape[:2]
    bt = block_table_rows.long()
    page, off, valid = _token_pages(block_table_rows, lengths, S, ps, start)
    nlp = -(-S // ps)
    a = torch.where(valid[..., None, None], rows_kv.float().abs(),
                    torch.zeros((), device=pool.device))
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, nlp * ps - S))
    a = a.reshape(B, nlp, ps, KV, D).amax(dim=(2, 4))         # (B, nlp, KV)
    wrote = torch.nn.functional.pad(valid, (0, nlp * ps - S)) \
        .reshape(B, nlp, ps).any(dim=2)
    phys = bt[:, :nlp]
    _masked_set(scales, (phys.reshape(-1),), a.reshape(B * nlp, KV),
                (wrote & (phys >= 0)).reshape(-1))
    s = torch.arange(S, device=pool.device)
    tok_scale = a[:, s // ps]                                  # (B, S, KV)
    q = quantize_to_i8(rows_kv, tok_scale[..., None])
    _masked_set(pool, (page.reshape(-1), off.reshape(-1)),
                q.reshape(B * S, KV, D), valid.reshape(-1))
    return pool, scales


def paged_prefill_write(entry, k, v, block_table_rows, lengths, start=None):
    """Write a prefill layer's (B,S,KV,D) K/V into its pool entry."""
    if is_quantized_entry(entry):
        quantize_rows_to_pages(entry["pk"], entry["pk_scale"], k,
                               block_table_rows, lengths, start)
        quantize_rows_to_pages(entry["pv"], entry["pv_scale"], v,
                               block_table_rows, lengths, start)
    else:
        scatter_rows_to_pages(entry["pk"], k, block_table_rows, lengths,
                              start)
        scatter_rows_to_pages(entry["pv"], v, block_table_rows, lengths,
                              start)
    return entry


def _append_token_i8(pool, scales, tok, page, off):
    """Append one (B,KV,D) token per row into int8 pages at (page, off).
    A token louder than its page's scale requantizes the whole page
    (q' = round(q · s_old / s_new)); a page's first token (off 0) ignores
    whatever scale a previous holder left."""
    P, ps, KV, D = pool.shape
    valid = page >= 0
    pidx = page.clamp(0, P - 1)
    s_old = torch.where((off == 0)[:, None], torch.zeros((), device=pool.device),
                        scales[pidx])
    amax = tok.float().abs().amax(dim=-1)
    s_new = torch.maximum(s_old, amax)
    ratio = torch.where(s_new > 0, s_old / torch.where(s_new > 0, s_new, 1.0),
                        torch.ones_like(s_new))
    pg = torch.round(pool[pidx].float() * ratio[:, None, :, None])
    q_tok = quantize_to_i8(tok, s_new[..., None]).float()
    sel = (torch.arange(ps, device=pool.device)[None, :]
           == off[:, None])[..., None, None]
    pg = torch.where(sel, q_tok[:, None], pg)
    _masked_set(pool, (pidx,), torch.clamp(pg, -127.0, 127.0), valid)
    _masked_set(scales, (pidx,), s_new, valid)


def _paged_append(entry, k_tok, v_tok, block_table, posv):
    """Decode-time single-token append into a paged entry (fp or int8).
    A position past the table (an idle row's clock keeps running) names no
    page and writes nothing, as the reference's out-of-range gather does."""
    ps = entry["pk"].shape[1]
    MP = block_table.shape[1]
    lp = posv.long() // ps
    page = torch.gather(block_table.long(), 1, lp.clamp(max=MP - 1)[:, None])
    page = torch.where(lp < MP, page[:, 0], -1)
    off = posv.long() % ps
    if is_quantized_entry(entry):
        _append_token_i8(entry["pk"], entry["pk_scale"], k_tok, page, off)
        _append_token_i8(entry["pv"], entry["pv_scale"], v_tok, page, off)
        return
    valid = page >= 0
    _masked_set(entry["pk"], (page, off), k_tok, valid)
    _masked_set(entry["pv"], (page, off), v_tok, valid)


def _valid_mask(cfg, kind: str, cap: int, pos):
    """Slots of a contiguous entry that hold a token at time ``pos`` (scalar
    or (B,)): ``i <= pos`` for a global entry; for a ring, the slots whose
    position ``pos - ((pos - i) mod cap)`` is not negative (local) or not
    before ``pos``'s chunk start (chunked)."""
    p = torch.as_tensor(pos)[..., None]
    i = torch.arange(cap, device=p.device)
    if kind == "global":
        m = i <= p
    else:
        slot_pos = p - torch.remainder(p - i, cap)
        if kind == "local":
            m = slot_pos >= 0
        else:
            m = slot_pos >= torch.div(p, cfg.chunk_size,
                                      rounding_mode="floor") * cfg.chunk_size
    return m if m.dim() == 2 else m[None, :]


# ------------------------------------------------------------ decode step
def _constrain(hints, x):
    """The reference's ``hints.constrain_act`` pin (the identity in one
    process, ``sharding.autoshard.ShardingHints``)."""
    return x if hints is None else hints.constrain_act(x)


def _layers(params, cache, cfg):
    """``transformer.layers_in_order`` with each layer's place: True for
    a layer of the stacked periods, after which the reference's scan body
    pins the activations; False for a remainder layer."""
    stacked = tfm.num_scan_periods(cfg) * tfm.scan_period(cfg)
    for i, (p, entry, kind) in enumerate(
            tfm.layers_in_order(params, cache, cfg)):
        yield p, entry, kind, i < stacked


def _positions(pos, B: int, device) -> torch.Tensor:
    """Scalar or (B,) pos -> (B,) int64."""
    p = torch.as_tensor(pos, device=device).long()
    return p.expand(B) if p.dim() == 0 else p


def _attn_decode(p, x, kind, entry, posv, cfg, block_table=None,
                 impl: Optional[str] = None, split_rows: Optional[int] = None,
                 tp: int = 1):
    """One token's attention: the paged entry through the paged kernel,
    a ring or dense slot through ``layers.decode_attention``; ``tp`` > 1
    runs either over tp KV-head shards (``sharding.tensor_parallel``), bit
    for bit the same."""
    q, k, v = tfm.attn_project(p, x, kind, posv[:, None], cfg)  # (B,1,H,D)
    if is_paged_entry(entry):
        if block_table is None:
            raise ValueError("a paged cache entry needs a block table")
        _paged_append(entry, k[:, 0], v[:, 0], block_table, posv)
        scales = {}
        if is_quantized_entry(entry):
            scales = dict(k_scale=entry["pk_scale"], v_scale=entry["pv_scale"])
        ctx = tensor_parallel.sharded_paged_attention(
            q, entry["pk"], entry["pv"], block_table,
            (posv + 1).to(torch.int32), tp, softcap=cfg.attn_logit_softcap,
            split_rows=split_rows, impl=impl, **scales)
        return layers.attn_out(p, ctx.to(COMPUTE_DTYPE))
    cap = entry["k"].shape[1]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    # a ring writes slot pos mod cap; a global entry clamps at its end
    idx = posv % cap if kind != "global" else posv.clamp(max=cap - 1)
    entry["k"][rows, idx] = k[:, 0]
    entry["v"][rows, idx] = v[:, 0]
    mask = _valid_mask(cfg, kind, cap, posv)
    ctx = tensor_parallel.sharded_decode_attention(
        q, entry["k"], entry["v"], mask.expand(B, cap), cfg, tp)
    return layers.attn_out(p, ctx)


def _recurrent_decode(p, h, kind, entry, cfg):
    """One token through an RG-LRU or SSD block; its new state is copied
    into ``entry``'s tensors (a captured step replays against them)."""
    if kind == "ssm":
        y, new = ssm_lib.ssm_block_decode(p["ssm"], h, entry, cfg)
    else:
        y, new = rglru_lib.rglru_block_decode(p["rglru"], h, entry, cfg)
    for key, t in entry.items():
        t.copy_(new[key])
    return y


def _block_decode(p, x, kind, entry, posv, cfg, plan, block_table, impl,
                  split_rows: Optional[int] = None, cond=None):
    """One layer: pre-norm mixer (attention or a recurrent block), the
    cross-attention of a config with one, then the MLP (none after an ssm
    layer)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind in RECURRENT_KINDS:
        y = _recurrent_decode(p, h, kind, entry, cfg)
    else:
        y = _attn_decode(p["attn"], h, kind, entry, posv, cfg, block_table,
                         impl, split_rows, plan_lib.mesh_degrees(plan)[0])
    x = tfm.cross_residual(p, tfm.residual(x, y, p, "post_norm", cfg), kind,
                           cond, cfg)
    if kind == "ssm":
        return x
    return tfm.mlp_residual(p, x, cfg, plan, impl)[0]


def serve_step(params, cache, tokens, pos, cfg, *, plan=None,
               block_table=None, cond=None, impl: Optional[str] = None,
               split_rows: Optional[int] = None, hints=None):
    """One decode step over every row. tokens (B,1), or (B,K,1) for K
    codebooks; pos scalar or (B,) per-row positions; ``block_table`` (B,
    max_pages) int32 routes paged entries through the paged-attention
    kernel; ``cond`` (B,T,d) is the conditioning sequence of a config with
    cross-attention. Writes the new token's K/V into ``cache`` in place.
    Returns (logits fp32 (B,1,Vp) or (B,1,K,Vp), cache). ``plan`` None
    routes by the active plan, else by the ``core.dataflow`` rules, as the
    reference's plan-less call does (``core.plan.route_mlp``). ``impl`` is
    passed on to ``kernels.ops`` (None: by device); ``split_rows`` to paged
    attention (``verify_step``'s real rows). ``hints``
    (``sharding.autoshard.make_hints``) are active over the step
    (``layers.hints_context``) and pin the activations where the
    reference's do (``constrain_act``)."""
    with layers.hints_context(hints):
        x = _constrain(hints, tfm.embed_tokens(params, tokens, cfg))
        B = x.shape[0]
        posv = _positions(pos, B, x.device)
        if cfg.pos_embed == "sinusoidal":
            x = x + layers.sinusoidal_pos(posv[:, None], cfg.d_model).to(
                COMPUTE_DTYPE)
        for p, entry, kind, stacked in _layers(params, cache, cfg):
            x = _block_decode(p, x, kind, entry, posv, cfg, plan,
                              block_table, impl, split_rows, cond)
            if stacked:
                x = _constrain(hints, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return tfm.lm_logits(params, x, cfg), cache


def verify_step(params, cache, tokens, pos, cfg, *, plan=None, block_table,
                cond=None, impl: Optional[str] = None, hints=None):
    """Score k candidate tokens per row in one step: the speculative
    verifier (the reference's ``verify_step``).

    tokens (B, k): row b's candidates, tokens[b, 0] at position pos[b].
    Returns (logits fp32 (B, k, Vp), cache), where logits[b, i] conditions
    on the row's history and tokens[b, :i + 1], as ``serve_step`` would
    after taking those tokens one at a time. The k positions flatten into
    the batch: each row's block table repeated k times gives k virtual rows
    on one page chain; virtual row i appends its token at pos + i (disjoint
    slots, one scatter) and reads with length pos + i + 1, so it sees its
    own prefix of the candidates and none after it. Paged attention splits
    the pages as for the B real rows. int8 pools take k sequential steps
    instead: a louder later token requantizes its whole page, so the order
    of appends is visible there. Only all-global-attention configs on a
    paged cache: a ring's per-row state cannot be replicated. ``cond``
    (B,T,d), the conditioning of a config with cross-attention, is
    repeated for each row's k virtual rows. ``hints`` are passed on to
    ``serve_step``."""
    if block_table is None:
        raise ValueError("verify_step needs a paged cache and its block "
                         "table")
    kinds = {k for k, _ in tfm.slot_kinds(cfg)}
    if kinds != {"global"}:
        raise ValueError(f"verify_step needs an all-global-attention "
                         f"config, got {sorted(kinds)}")
    B, k = tokens.shape
    posv = _positions(pos, B, tokens.device)
    if any(is_quantized_entry(e) for part in cache.values()
           for e in part.values()):
        outs = []
        for i in range(k):
            lg, cache = serve_step(params, cache, tokens[:, i:i + 1],
                                   posv + i, cfg, plan=plan,
                                   block_table=block_table, cond=cond,
                                   impl=impl, hints=hints)
            outs.append(lg)
        return torch.cat(outs, dim=1), cache
    posf = (posv[:, None] + torch.arange(k, device=posv.device)[None, :]
            ).reshape(-1)
    logits, cache = serve_step(
        params, cache, tokens.reshape(-1, 1), posf, cfg, plan=plan,
        block_table=block_table.repeat_interleave(k, dim=0),
        cond=None if cond is None else cond.repeat_interleave(k, dim=0),
        impl=impl, split_rows=B, hints=hints)
    return logits.reshape((B, k) + logits.shape[2:]), cache


# ----------------------------------------------------------------- prefill
@dataclasses.dataclass
class PagedPrefill:
    """Page-native prefill: global K/V written straight into the pools of
    ``cache`` through per-row block tables as each layer produces it, and
    every per-row entry (a local layer's ring) merged into its device row
    at ``slots``. ``write_start`` (B,) skips writes before each row's
    shared-prefix boundary; None writes from token 0."""
    cache: Dict
    block_table_rows: torch.Tensor      # (B, max_pages) physical page ids
    slots: torch.Tensor                 # (B,) device rows being refilled
    write_start: Optional[torch.Tensor] = None


def _gather_ring_ragged(full, m: int, lengths):
    """Per-row ring of m slots from (B,S,...) K or V: row b's slots hold its
    own last positions at pos = lengths[b] - 1, so pad tokens past a row's
    length never enter; slots that would map to negative positions clip to
    0 (garbage the decode-side validity mask hides)."""
    S = full.shape[1]
    i = torch.arange(m, device=full.device)
    last = (lengths.long() - 1)[:, None]
    p = (last - torch.remainder(last - i[None, :], m)).clamp(0, S - 1)
    idx = p.reshape(p.shape + (1,) * (full.dim() - 2)).expand(
        p.shape + full.shape[2:])
    return torch.gather(full, 1, idx)


def _merge_rows(entry, row_entry, slots) -> None:
    """Write B prefilled rows into a full-width per-row entry at ``slots``:
    every leaf (K/V rings, or a recurrent layer's window and state), so a
    reused row keeps nothing of its previous request."""
    for key, t in entry.items():
        t[slots] = row_entry[key].to(t.dtype)


def _attn_prefill(p, x, kind, positions, cfg, cache_len: int, lengths,
                  entry=None, paged: Optional[PagedPrefill] = None,
                  impl: Optional[str] = None):
    q, k, v = tfm.attn_project(p, x, kind, positions, cfg)
    ctx = tfm.attend(q, k, v, kind, cfg, impl)
    cap = _attn_cache_capacity(cfg, kind, cache_len)
    if paged is not None and is_paged_entry(entry):
        paged_prefill_write(entry, k, v, paged.block_table_rows, lengths,
                            paged.write_start)
        return layers.attn_out(p, ctx), entry
    if kind == "global":
        # rows keep pad K/V past their length; decode's validity mask
        # never exposes it and decode overwrites it in order
        pad = cap - k.shape[1]
        out_entry = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                     "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    else:
        out_entry = {"k": _gather_ring_ragged(k, cap, lengths),
                     "v": _gather_ring_ragged(v, cap, lengths)}
    if paged is not None:
        _merge_rows(entry, out_entry, paged.slots)
        out_entry = entry
    return layers.attn_out(p, ctx), out_entry


def _block_prefill(p, x, kind, positions, cfg, cache_len, lengths, entry,
                   paged, plan, impl, cond=None):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind in RECURRENT_KINDS:
        block = ssm_lib.ssm_block if kind == "ssm" else rglru_lib.rglru_block
        y, e = block(p[kind], h, cfg, return_state=True)
        if paged is not None:
            _merge_rows(entry, e, paged.slots)
            e = entry
    else:
        y, e = _attn_prefill(p["attn"], h, kind, positions, cfg, cache_len,
                             lengths, entry, paged, impl)
    x = tfm.cross_residual(p, tfm.residual(x, y, p, "post_norm", cfg), kind,
                           cond, cfg)
    if kind == "ssm":
        return x, e
    return tfm.mlp_residual(p, x, cfg, plan, impl)[0], e


def _prefill_impl(params, tokens, cfg, cache_len: int, lengths, *, plan,
                  paged: Optional[PagedPrefill] = None,
                  impl: Optional[str] = None, patch_embeds=None, cond=None,
                  hints=None):
    with layers.hints_context(hints):
        x, positions = tfm.embed_inputs(params, tokens, cfg, patch_embeds)
        x = _constrain(hints, x)
        B = x.shape[0]
        entries = []
        for p, entry, kind, stacked in _layers(
                params, paged.cache if paged is not None else None, cfg):
            x, e = _block_prefill(p, x, kind, positions, cfg, cache_len,
                                  lengths, entry, paged, plan, impl, cond)
            if stacked:
                x = _constrain(hints, x)
            entries.append(e)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        idx = (lengths.long() - 1)[:, None, None].expand(B, 1, x.shape[-1])
        logits = tfm.lm_logits(params, torch.gather(x, 1, idx), cfg)
        if paged is not None:
            return logits, paged.cache
        # the fresh cache in the reference's layout: per slot, its periods'
        # entries stacked; the remainder layers' as they are
        it = iter(entries)
        periods = [{name: next(it) for name, _ in tfm.slot_names(cfg)}
                   for _ in range(tfm.num_scan_periods(cfg))]
        cache = {}
        if periods:
            cache["blocks"] = {
                name: {k: torch.stack([per[name][k] for per in periods])
                       for k in periods[0][name]}
                for name, _ in tfm.slot_names(cfg)}
        if tfm.num_remainder(cfg):
            cache["rem"] = {name: next(it) for name, _ in tfm.rem_names(cfg)}
        return logits, cache


def _check_exact(cfg, tokens, lengths) -> None:
    """A recurrent config's prefill must see exactly its prompts: every row
    one length, that of ``tokens`` (padding would enter the carried state).
    Reads ``lengths`` on the host: a device tensor is copied back, one
    transfer per recurrent prefill batch, outside any captured step."""
    S = tokens.shape[1]
    host = lengths.cpu().numpy() if isinstance(lengths, torch.Tensor) \
        else np.asarray(lengths)
    if (host != S).any():
        raise ValueError(
            f"{cfg.name} carries recurrent state: prefill takes prompts of "
            f"one exact length (got lengths {host.tolist()} in a batch of "
            f"{S} tokens); pad tokens would enter the state")


def prefill_batched(params, tokens, lengths, cfg, cache_len: int, *,
                    plan=None,
                    paged: Optional[PagedPrefill] = None, cond=None,
                    impl: Optional[str] = None, hints=None):
    """Batched prefill over right-padded prompts of unequal length.

    tokens (B, S) padded to a common tier S; lengths (B,) the real prompt
    lengths. Returns (per-row last-real-position logits (B,1,Vp), cache).
    Without ``paged`` the cache is a fresh contiguous one (global slots
    (periods, B, cache_len, KV, D), local slots per-row rings); with it,
    global K/V land in ``paged.cache``'s pools and rings in its rows at
    ``paged.slots`` (in place). ``cond`` is the conditioning sequence of a
    config with cross-attention. A vision config is refused, as the
    reference's assert refuses it: the per-row last position and the ring
    gathers do not carry the patches' offset; ``prefill`` takes patches.
    ``impl`` is passed on to ``kernels.ops`` (None: by device); ``hints``
    as in ``prefill``."""
    if cfg.frontend == "vision" and cfg.num_patches:
        raise ValueError(
            f"{cfg.name}: prefill_batched does not take vision patches "
            "(its per-row lengths do not carry their offset); prefill "
            "(patch_embeds=) does")
    if is_recurrent(cfg):
        _check_exact(cfg, tokens, lengths)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    return _prefill_impl(params, tokens, cfg, cache_len, lengths, plan=plan,
                         paged=paged, impl=impl, cond=cond, hints=hints)


def prefill(params, tokens, cfg, cache_len: int, *, plan=None,
            patch_embeds=None,
            cond=None, impl: Optional[str] = None, hints=None):
    """Forward over (B, S) prompts of one length S ((B, K, S) for K
    codebooks), building a fresh contiguous cache (global slots (periods,
    B, cache_len, KV, D), local slots rings at the last position).
    ``patch_embeds`` (B, P, d) of a vision config are prepended to the
    text (S + P positions); ``cond`` (B, T, d) is the conditioning of a
    config with cross-attention. Returns (last-position logits fp32
    (B,1,Vp) or (B,1,K,Vp), cache). The single-length case of
    ``prefill_batched``. ``hints`` (``sharding.autoshard.make_hints``)
    are active over the prefill (``layers.hints_context``: attention
    sequence-sharded where the reference's is, ``layers.seq_shards``) and
    pin the activations where the reference's do (``constrain_act``)."""
    B, S = tokens.shape[0], tokens.shape[-1]
    if cfg.frontend == "vision" and patch_embeds is not None:
        S += patch_embeds.shape[1]
    lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return _prefill_impl(params, tokens, cfg, cache_len, lengths, plan=plan,
                         impl=impl, patch_embeds=patch_embeds, cond=cond,
                         hints=hints)
