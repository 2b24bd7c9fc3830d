"""KV caches, single-token decode and batched prefill for global and
sliding-window (local) attention layers (counterpart of
``repro.models.decoding``).

Caches keep the reference's layout: entries of the stacked layers sit on a
leading period axis (``cache["blocks"]["slot{j}"]``, one per slot of the
layer pattern). A global entry is either a contiguous ``(periods, rows,
cache_len, KV, D)`` K/V or a paged one, ``(periods, num_pages, page_size,
KV, D)`` pools (``pk``, ``pv``) plus, in the int8 format, ``(periods,
num_pages, KV)`` fp32 amax scales. A local entry is a per-row bf16 ring of
``min(window, cache_len)`` slots in both layouts: slot ``i`` holds the token
at the largest position ``p = i (mod cap)`` with ``p <= pos``, and validity
is recomputed from ``pos`` at every step.

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
def _attn_cache_capacity(cfg, kind: str, cache_len: int) -> int:
    return min(cfg.window_size, cache_len) if kind == "local" else cache_len


def _init_entry(cfg, kind: str, rows: int, cache_len: int, device):
    """Per-row (periods, rows, cap, KV, D) bf16 K/V of one slot."""
    shape = (tfm.num_scan_periods(cfg), rows,
             _attn_cache_capacity(cfg, kind, cache_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def init_cache(cfg, batch: int, cache_len: int, device=None) -> Dict:
    """Contiguous K/V for global slots, rings for local ones."""
    tfm.check_supported(cfg)
    return {"blocks": {name: _init_entry(cfg, kind, batch, cache_len, device)
                       for name, kind in tfm.slot_names(cfg)}}


def _init_paged_entry(cfg, num_pages: int, page_size: int, kv_quant: str,
                      device):
    L = tfm.num_scan_periods(cfg)
    shape = (L, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant == "int8":
        sshape = (L, num_pages, cfg.num_kv_heads)
        return {"pk": torch.zeros(shape, dtype=torch.int8, device=device),
                "pv": torch.zeros(shape, dtype=torch.int8, device=device),
                "pk_scale": torch.zeros(sshape, device=device),
                "pv_scale": torch.zeros(sshape, device=device)}
    return {"pk": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "pv": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def init_paged_cache(cfg, rows: int, cache_len: int, num_pages: int,
                     page_size: int, kv_quant: str = "fp",
                     device=None) -> Dict:
    """Global slots as (periods, num_pages, page_size, KV, D) pools, bf16
    or int8 with per-(page, KV head) fp32 scales; local slots keep their
    per-row rings, whose memory never grows with the context."""
    tfm.check_supported(cfg)
    if kv_quant not in dataflow.KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {dataflow.KV_QUANT_DTYPES}")
    return {"blocks": {
        name: _init_paged_entry(cfg, num_pages, page_size, kv_quant, device)
        if kind == "global" else _init_entry(cfg, kind, rows, cache_len,
                                             device)
        for name, kind in tfm.slot_names(cfg)}}


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
    position ``pos - ((pos - i) mod cap)`` is not negative."""
    p = torch.as_tensor(pos)[..., None]
    i = torch.arange(cap, device=p.device)
    if kind == "global":
        m = i <= p
    elif kind == "local":
        m = p - torch.remainder(p - i, cap) >= 0
    else:
        raise NotImplementedError(f"{kind} layers are not ported yet")
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
    theta = tfm._rope_theta_for(cfg, kind)
    q = layers.rope(q, posv[:, None], theta)
    k = layers.rope(k, posv[:, None], theta)
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
    # a ring writes slot pos mod cap; a global entry clamps at its end
    idx = posv % cap if kind != "global" else posv.clamp(max=cap - 1)
    entry["k"][rows, idx] = k[:, 0]
    entry["v"][rows, idx] = v[:, 0]
    mask = _valid_mask(cfg, kind, cap, posv)
    ctx = layers.decode_attention(q, entry["k"], entry["v"],
                                  mask.expand(B, cap), cfg)
    return layers.attn_out(p, ctx)


def _residual(x, y, p, post: str, cfg):
    """x + y, y first through gemma2's post-norm when the config has one."""
    if cfg.use_post_norm:
        y = rms_norm(y, p[post], cfg.norm_eps)
    return x + y


def _mlp_residual(p, x, cfg, plan, impl):
    h = rms_norm(x, p["pre_norm_mlp"], cfg.norm_eps)
    return _residual(x, layers.mlp(p["mlp"], h, cfg, plan, impl=impl), p,
                     "post_norm_mlp", cfg)


def _block_decode(p, x, kind, entry, posv, cfg, plan, block_table, impl):
    """One layer: pre-norm attention, then the MLP."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    y = _attn_decode(p["attn"], h, kind, entry, posv, cfg, block_table, impl)
    return _mlp_residual(p, _residual(x, y, p, "post_norm", cfg), cfg, plan,
                         impl)


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
    slots = tfm.slot_names(cfg)
    for i in range(tfm.num_scan_periods(cfg)):
        for name, kind in slots:
            x = _block_decode(tfm.layer(params["blocks"][name], i), x, kind,
                              tfm.layer(cache["blocks"][name], i), posv, cfg,
                              plan, block_table, impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.lm_logits(params, x, cfg), cache


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
    """Write B prefilled rows into a full-width per-row entry at ``slots``."""
    for key, t in entry.items():
        t[slots] = row_entry[key].to(t.dtype)


def _attn_prefill(p, x, kind, positions, cfg, cache_len: int, lengths,
                  entry=None, paged: Optional[PagedPrefill] = None,
                  impl: Optional[str] = None):
    q, k, v = layers.attn_qkv(p, x, cfg)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    theta = tfm._rope_theta_for(cfg, kind)
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    if kind == "local":
        ctx = layers.local_attention(q, k, v, cfg, impl)
    else:
        ctx = layers.full_causal_attention(q, k, v, cfg, impl)
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
                   paged, plan, impl):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    y, e = _attn_prefill(p["attn"], h, kind, positions, cfg, cache_len,
                         lengths, entry, paged, impl)
    return _mlp_residual(p, _residual(x, y, p, "post_norm", cfg), cfg, plan,
                         impl), e


def _prefill_impl(params, tokens, cfg, cache_len: int, lengths, *, plan,
                  paged: Optional[PagedPrefill] = None,
                  impl: Optional[str] = None):
    x = tfm.embed_tokens(params, tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    slots = tfm.slot_names(cfg)
    entries = {name: [] for name, _ in slots}
    for i in range(tfm.num_scan_periods(cfg)):
        for name, kind in slots:
            entry = tfm.layer(paged.cache["blocks"][name], i) \
                if paged is not None else None
            x, e = _block_prefill(tfm.layer(params["blocks"][name], i), x,
                                  kind, positions, cfg, cache_len, lengths,
                                  entry, paged, plan, impl)
            entries[name].append(e)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = (lengths.long() - 1)[:, None, None].expand(B, 1, x.shape[-1])
    logits = tfm.lm_logits(params, torch.gather(x, 1, idx), cfg)
    if paged is not None:
        return logits, paged.cache
    return logits, {"blocks": {
        name: {k: torch.stack([e[k] for e in es]) for k in ("k", "v")}
        for name, es in entries.items()}}


def prefill_batched(params, tokens, lengths, cfg, cache_len: int, *, plan,
                    paged: Optional[PagedPrefill] = None,
                    impl: Optional[str] = None):
    """Batched prefill over right-padded prompts of unequal length.

    tokens (B, S) padded to a common tier S; lengths (B,) the real prompt
    lengths. Returns (per-row last-real-position logits (B,1,Vp), cache).
    Without ``paged`` the cache is a fresh contiguous one (global slots
    (periods, B, cache_len, KV, D), local slots per-row rings); with it,
    global K/V land in ``paged.cache``'s pools and rings in its rows at
    ``paged.slots`` (in place).
    ``impl`` is passed on to ``kernels.ops`` (None: by device)."""
    tfm.check_supported(cfg)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    return _prefill_impl(params, tokens, cfg, cache_len, lengths, plan=plan,
                         paged=paged, impl=impl)


def prefill(params, tokens, cfg, cache_len: int, *, plan,
            impl: Optional[str] = None):
    """Forward over (B, S) prompts of one length S, building a fresh
    contiguous cache (global slots (periods, B, cache_len, KV, D), local
    slots rings at pos = S - 1). Returns (last-position logits fp32
    (B,1,Vp), cache). The single-length case of ``prefill_batched``."""
    tfm.check_supported(cfg)
    B, S = tokens.shape
    lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return _prefill_impl(params, tokens, cfg, cache_len, lengths, plan=plan,
                         impl=impl)
