"""Core layers of the port (counterpart of ``repro.models.layers``).

Precision is the reference's: matmul operands in bf16 with fp32 accumulation
(fp32 results wherever the reference asks for ``preferred_element_type=f32``),
norms and softmax in fp32, and ``attn_out`` and the dense down-projection
returning bf16. Weight matrices may already be stored as bf16 copies
(``transformer.compute_copy``); ``cast_compute`` then leaves them as they are.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -2.0e38


def cast_compute(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == COMPUTE_DTYPE else x.to(COMPUTE_DTYPE)


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype=torch.float32) -> torch.Tensor:
    """x (..., K) · w (K, N) with bf16 operands and fp32 accumulation,
    returned as ``out_dtype`` (one rounding of the fp32 sum)."""
    lead = x.shape[:-1]
    x2 = cast_compute(x).reshape(-1, x.shape[-1])
    w2 = cast_compute(w)
    if x2.is_cuda:
        y = torch.mm(x2, w2, out_dtype=torch.float32) \
            if out_dtype == torch.float32 else torch.mm(x2, w2)
    else:
        y = x2.float() @ w2.float()
    return y.to(out_dtype).reshape(lead + (w.shape[-1],))


# --------------------------------------------------------------------- norm
def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def head_rms_norm(x, scale, eps: float):
    """qk-norm over the head_dim axis of (..., D)."""
    return rms_norm(x, scale, eps)


# --------------------------------------------------------------------- rope
def rope(x, positions, theta: float):
    """Rotary embedding. x (..., S, H, D); positions (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python base: no host-to-device copy, so a decode step captures
    freq = torch.pow(float(theta), exps)
    angles = positions[..., :, None].float() * freq
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    if cap and cap > 0.0:
        logits = torch.tanh(logits / cap) * cap
    return logits


# ---------------------------------------------------------------- attention
def attn_qkv(params, x, cfg):
    """x (B,S,d) -> q (B,S,H,D), k/v (B,S,KV,D), bf16 (bias added in fp32)."""
    out = []
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        wt = params[w]
        n, hd = wt.shape[-2:]
        y = matmul(x, wt.reshape(wt.shape[0], n * hd)).reshape(
            x.shape[:-1] + (n, hd))
        if cfg.qkv_bias:
            y = y + params[b].float()
        out.append(y.to(COMPUTE_DTYPE))
    return tuple(out)


def attn_out(params, ctx):
    """ctx (B,S,H,D) -> (B,S,d) in bf16."""
    wo = params["wo"]
    H, D, d = wo.shape
    return matmul(ctx.reshape(ctx.shape[:-2] + (H * D,)),
                  wo.reshape(H * D, d), out_dtype=COMPUTE_DTYPE)


def full_causal_attention(q, k, v, cfg, impl: Optional[str] = None):
    """Causal prefill attention through ``ops.flash_attention`` (the
    reference's ``_flash_call`` onto ``models/flash.py``): the CUDA kernel
    on the card, its plain version (flash's numerics and block schedule) on
    the CPU. q (B,S,H,D); k, v (B,S,KV,D) -> (B,S,H,D) bf16."""
    return ops.flash_attention(q, k, v, softcap=cfg.attn_logit_softcap,
                               impl=impl).to(COMPUTE_DTYPE)


def local_attention(q, k, v, cfg, impl: Optional[str] = None):
    """Sliding-window causal attention with window ``cfg.window_size``;
    causal when the sequence fits in the window, as in the reference."""
    w = cfg.window_size
    if q.shape[1] <= w:
        return full_causal_attention(q, k, v, cfg, impl)
    return ops.sliding_window_attention(
        q, k, v, window=w, softcap=cfg.attn_logit_softcap,
        impl=impl).to(COMPUTE_DTYPE)


def decode_attention(q, k_cache, v_cache, valid_mask, cfg):
    """One-token attention against a contiguous cache.
    q (B,1,H,D); k/v_cache (B,T,KV,D); valid_mask (B,T) bool."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    qr = q.reshape(B, 1, KV, H // KV, D).float()
    s = torch.einsum("bsgrd,btgd->bgrst", qr, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    s = softcap(s, cfg.attn_logit_softcap)
    s = torch.where(valid_mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bgrst,btgd->bsgrd", p, v_cache.float())
    return ctx.reshape(B, 1, H, D).to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------- MLP
def _packed_proj(x, packed, n_out: int, plan,
                 activation: Optional[str] = None, impl: Optional[str] = None):
    """(B,S,d) · packed BCSC weight -> (B,S,n_out) fp32 via the sparse
    kernels (GEMV arm at decode M, GEMM arm otherwise)."""
    B, S, d = x.shape
    y = ops.bcsc_apply_packed(x.reshape(B * S, d), packed, n_out=n_out,
                              plan=plan, activation=activation, impl=impl)
    return y.reshape(B, S, n_out)


def mlp(params, x, cfg, plan, d_ff: Optional[int] = None,
        impl: Optional[str] = None):
    """Gated (SwiGLU/GeGLU) or plain MLP. When every projection is packed
    and the plan routes M = B·S 'fused', the whole MLP is one fused sparse
    kernel; packed projections otherwise take the two-call sparse arm, and
    dense ones the bf16 matmuls. ``impl`` is passed on to ``kernels.ops``."""
    act_name = "silu" if cfg.mlp_act == "silu" else "gelu"
    ff = d_ff or (cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff)
    d = x.shape[-1]
    B, S, _ = x.shape

    def act(t):
        return F.silu(t) if cfg.mlp_act == "silu" \
            else F.gelu(t, approximate="tanh")

    names = ("wg", "wu", "wd") if cfg.mlp_gated else ("w1", "w2")
    if all(ops.is_packed(params[n]) for n in names) \
            and plan.mlp_route(B * S) == "fused":
        up2 = params["wu"] if cfg.mlp_gated else None
        y = ops.bcsc_mlp_packed(
            x.reshape(B * S, d), params[names[0]], up2, params[names[-1]],
            d_ff=ff, n_out=d, plan=plan, activation=act_name,
            counts=params.get("_bcsc_counts"), impl=impl)
        return y.reshape(B, S, d).to(COMPUTE_DTYPE)

    if cfg.mlp_gated:
        wg, wu = params["wg"], params["wu"]
        g_act = _packed_proj(x, wg, ff, plan, act_name, impl) \
            if ops.is_packed(wg) else act(matmul(x, wg))
        u = _packed_proj(x, wu, ff, plan, impl=impl) if ops.is_packed(wu) \
            else matmul(x, wu)
        h = (g_act * u).to(COMPUTE_DTYPE)
    else:
        w1 = params["w1"]
        h = (_packed_proj(x, w1, ff, plan, act_name, impl)
             if ops.is_packed(w1) else act(matmul(x, w1))).to(COMPUTE_DTYPE)
    wd = params["wd"] if cfg.mlp_gated else params["w2"]
    if ops.is_packed(wd):
        return _packed_proj(h, wd, d, plan, impl=impl).to(COMPUTE_DTYPE)
    return matmul(h, wd, out_dtype=COMPUTE_DTYPE)
