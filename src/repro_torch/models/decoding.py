"""KV caches, single-token decode and batched prefill, global attention
(counterpart of ``repro.models.decoding``).

Caches keep the reference's layout: entries of the stacked layers sit on a
leading layer axis (``cache["blocks"]["slot0"]``), and a paged entry holds
``(layers, num_pages, page_size, KV, D)`` pools (``pk``, ``pv``) plus, in the
int8 format, ``(layers, num_pages, KV)`` fp32 amax scales.

Unlike the reference, which returns new caches, every function here writes
the cache it is given in place and returns it: the pools are the largest
tensors of a serving run and are never copied. Writes that the reference
drops (positions past a row's length, table entries of -1) are masked here
without reading anything back to the host, so a decode chunk stays free of
device-to-host transfers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import dataflow
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE, rms_norm


# ------------------------------------------------------------------ caches
def init_cache(cfg, batch: int, cache_len: int, device=None) -> Dict:
    """Contiguous (layers, batch, cache_len, KV, D) bf16 K/V."""
    tfm.check_supported(cfg)
    shape = (tfm.num_scan_periods(cfg), batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"blocks": {"slot0": {
        "k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}}}


def init_paged_cache(cfg, rows: int, cache_len: int, num_pages: int,
                     page_size: int, kv_quant: str = "fp",
                     device=None) -> Dict:
    """Global-attention K/V as (layers, num_pages, page_size, KV, D) pools,
    bf16 or int8 with per-(page, KV head) fp32 scales."""
    tfm.check_supported(cfg)
    if kv_quant not in dataflow.KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {dataflow.KV_QUANT_DTYPES}")
    L = tfm.num_scan_periods(cfg)
    shape = (L, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant == "int8":
        sshape = (L, num_pages, cfg.num_kv_heads)
        entry = {"pk": torch.zeros(shape, dtype=torch.int8, device=device),
                 "pv": torch.zeros(shape, dtype=torch.int8, device=device),
                 "pk_scale": torch.zeros(sshape, device=device),
                 "pv_scale": torch.zeros(sshape, device=device)}
    else:
        entry = {"pk": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                 "pv": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    return {"blocks": {"slot0": entry}}


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
    """Global kind: slot i is valid when i <= pos. pos scalar or (B,)."""
    if kind != "global":
        raise NotImplementedError(f"{kind} layers are not ported yet")
    p = torch.as_tensor(pos)
    i = torch.arange(cap, device=p.device)
    m = i <= p[..., None]
    return m if m.dim() == 2 else m[None, :]


# ------------------------------------------------------------ decode step
def _positions(pos, B: int, device) -> torch.Tensor:
    """Scalar or (B,) pos -> (B,) int64."""
    p = torch.as_tensor(pos, device=device).long()
    return p.expand(B) if p.dim() == 0 else p


def _attn_decode(p, x, kind, entry, posv, cfg, block_table=None,
                 impl: Optional[str] = None):
    q, k, v = layers.attn_qkv(p, x, cfg)               # q (B,1,H,D)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.rope(q, posv[:, None], cfg.rope_theta)
    k = layers.rope(k, posv[:, None], cfg.rope_theta)
    if is_paged_entry(entry):
        if block_table is None:
            raise ValueError("a paged cache entry needs a block table")
        _paged_append(entry, k[:, 0], v[:, 0], block_table, posv)
        scales = {}
        if is_quantized_entry(entry):
            scales = dict(k_scale=entry["pk_scale"], v_scale=entry["pv_scale"])
        ctx = ops.paged_attention(q, entry["pk"], entry["pv"], block_table,
                                  (posv + 1).to(torch.int32),
                                  softcap=cfg.attn_logit_softcap,
                                  impl=impl, **scales)
        return layers.attn_out(p, ctx.to(COMPUTE_DTYPE))
    cap = entry["k"].shape[1]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    idx = posv.clamp(max=cap - 1)
    entry["k"][rows, idx] = k[:, 0]
    entry["v"][rows, idx] = v[:, 0]
    mask = _valid_mask(cfg, kind, cap, posv)
    ctx = layers.decode_attention(q, entry["k"], entry["v"],
                                  mask.expand(B, cap), cfg)
    return layers.attn_out(p, ctx)


def serve_step(params, cache, tokens, pos, cfg, *, plan, block_table=None,
               impl: Optional[str] = None):
    """One decode step over every row. tokens (B,1); pos scalar or (B,)
    per-row positions; ``block_table`` (B, max_pages) int32 routes paged
    entries through the paged-attention kernel. Writes the new token's K/V
    into ``cache`` in place. Returns (logits fp32 (B,1,Vp), cache).
    ``impl`` is passed on to ``kernels.ops`` (None: by device)."""
    x = tfm.embed_tokens(params, tokens, cfg)
    B = x.shape[0]
    posv = _positions(pos, B, x.device)
    blocks, cblocks = params["blocks"]["slot0"], cache["blocks"]["slot0"]
    for i in range(tfm.num_scan_periods(cfg)):
        p, entry = tfm.layer(blocks, i), tfm.layer(cblocks, i)
        h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
        x = x + _attn_decode(p["attn"], h, "global", entry, posv, cfg,
                             block_table, impl)
        h = rms_norm(x, p["pre_norm_mlp"], cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, cfg, plan, impl=impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.lm_logits(params, x, cfg), cache


# ----------------------------------------------------------------- prefill
@dataclasses.dataclass
class PagedPrefill:
    """Page-native prefill: global K/V written straight into the pools of
    ``cache`` through per-row block tables as each layer produces it.
    ``write_start`` (B,) skips writes before each row's shared-prefix
    boundary; None writes from token 0."""
    cache: Dict
    block_table_rows: torch.Tensor      # (B, max_pages) physical page ids
    slots: torch.Tensor                 # (B,) device rows being refilled
    write_start: Optional[torch.Tensor] = None


def _attn_prefill(p, x, positions, cfg, cache_len: int, lengths,
                  entry=None, paged: Optional[PagedPrefill] = None):
    q, k, v = layers.attn_qkv(p, x, cfg)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    ctx = layers.full_causal_attention(q, k, v, cfg)
    if paged is not None:
        paged_prefill_write(entry, k, v, paged.block_table_rows, lengths,
                            paged.write_start)
        out_entry = entry
    else:
        # rows keep pad K/V past their length; decode's validity mask
        # never exposes it and decode overwrites it in order
        pad = cache_len - k.shape[1]
        out_entry = {
            "k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return layers.attn_out(p, ctx), out_entry


def _prefill_impl(params, tokens, cfg, cache_len: int, lengths, *, plan,
                  paged: Optional[PagedPrefill] = None,
                  impl: Optional[str] = None):
    x = tfm.embed_tokens(params, tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    blocks = params["blocks"]["slot0"]
    cblocks = paged.cache["blocks"]["slot0"] if paged is not None else None
    entries = []
    for i in range(tfm.num_scan_periods(cfg)):
        p = tfm.layer(blocks, i)
        h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
        y, e = _attn_prefill(p["attn"], h, positions, cfg, cache_len, lengths,
                             tfm.layer(cblocks, i) if paged is not None
                             else None, paged)
        entries.append(e)
        x = x + y
        h = rms_norm(x, p["pre_norm_mlp"], cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, cfg, plan, impl=impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = (lengths.long() - 1)[:, None, None].expand(B, 1, x.shape[-1])
    logits = tfm.lm_logits(params, torch.gather(x, 1, idx), cfg)
    if paged is not None:
        return logits, paged.cache
    return logits, {"blocks": {"slot0": {
        k: torch.stack([e[k] for e in entries]) for k in ("k", "v")}}}


def prefill_batched(params, tokens, lengths, cfg, cache_len: int, *, plan,
                    paged: Optional[PagedPrefill] = None,
                    impl: Optional[str] = None):
    """Batched prefill over right-padded prompts of unequal length.

    tokens (B, S) padded to a common tier S; lengths (B,) the real prompt
    lengths. Returns (per-row last-real-position logits (B,1,Vp), cache).
    Without ``paged`` the cache is a fresh contiguous (layers, B, cache_len,
    KV, D) one; with it, K/V land in ``paged.cache``'s pools (in place).
    ``impl`` is passed on to ``kernels.ops`` (None: by device)."""
    tfm.check_supported(cfg)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    return _prefill_impl(params, tokens, cfg, cache_len, lengths, plan=plan,
                         paged=paged, impl=impl)
