"""Core layers of the port (counterpart of ``repro.models.layers``).

Precision is the reference's: matmul operands in bf16 with fp32 accumulation
(fp32 results wherever the reference asks for ``preferred_element_type=f32``),
norms and softmax in fp32, and ``attn_out`` and the dense down-projection
returning bf16. Weight matrices may already be stored as bf16 copies
(``transformer.compute_copy``); ``cast_compute`` then leaves them as they are.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import plan as plan_lib
from repro_torch.kernels import ops
from repro_torch.models import flash

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -2.0e38


# ------------------------------------------------------- sharding-hints context
# Set by ``transformer.forward`` around its layers (``sharding.autoshard.
# ShardingHints``), as the reference's ``launch/cell.py`` sets it around
# tracing. The one place the hints change the computation is
# ``_band_attention``'s sequence-sharded branch; ``constrain`` is the
# reference's placement pin, which in one process returns its input.
_HINTS: contextvars.ContextVar = contextvars.ContextVar("hints", default=None)


def set_hints(hints):
    return _HINTS.set(hints)


def reset_hints(token):
    _HINTS.reset(token)


@contextlib.contextmanager
def hints_context(hints):
    """``hints`` active for the block; None leaves the context as it is."""
    if hints is None:
        yield
        return
    token = set_hints(hints)
    try:
        yield
    finally:
        reset_hints(token)


def constrain(x, tp_dim: Optional[int] = None, tp_check=None,
              batch_dim: int = 0, tp_candidates=None,
              widen_batch: bool = False):
    h = _HINTS.get()
    if h is None:
        return x
    return h.constrain_tokens(x, tp_dim=tp_dim, tp_check=tp_check,
                              batch_dim=batch_dim,
                              tp_candidates=tp_candidates,
                              widen_batch=widen_batch)


def seq_shards(S: int, H: int, KV: int) -> int:
    """How many sequence shards the reference's ``_flash_call`` cuts the
    query rows into under the active hints: the model axis's size when
    tensor parallelism is on and the head counts do not divide it, S
    divides it and each shard keeps at least 128 rows; else 1."""
    h = _HINTS.get()
    ms = h.model_size if h is not None else 1
    if h is None or not h.tp or ms <= 1 or (H % ms == 0 and KV % ms == 0):
        return 1
    return ms if S % ms == 0 and S // ms >= 128 else 1


def cast_compute(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == COMPUTE_DTYPE else x.to(COMPUTE_DTYPE)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b with fp32 accumulation and an fp32 result: bf16 operands on
    the card (``torch.mm``'s ``out_dtype``), an fp32 product of the same
    values on the CPU, or of fp32 operands anywhere."""
    if a.is_cuda and a.dtype == b.dtype == COMPUTE_DTYPE:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _cotangent(g: torch.Tensor) -> torch.Tensor:
    """A product's fp32 cotangent as its backward products take it: in
    fp32 on the CPU, as XLA's CPU backend takes it; on the card rounded to
    bf16 first (bf16 tensor-core products with fp32 accumulation, the
    TPU's default precision for the reference's mixed products)."""
    return g.to(COMPUTE_DTYPE) if g.is_cuda else g


class _Matmul(torch.autograd.Function):
    """(M, K) · (K, N) on bf16 operands with fp32 accumulation, fp32 out,
    and the reference's backward of a bf16 einsum with an fp32 result:
    each operand's cotangent is the fp32 sum rounded once to bf16 (its
    dtype). The weight is taken as stored (fp32 params, or a bf16 copy)
    and cast in both passes, so that no bf16 copy of it is kept for the
    backward. The fp32 cotangent reaches the products through
    ``_cotangent``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, cast_compute(w))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        w2 = cast_compute(w)
        g = _cotangent(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w2.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.t(), g).to(COMPUTE_DTYPE).to(w.dtype)
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype=torch.float32) -> torch.Tensor:
    """x (..., K) · w (K, N) with bf16 operands and fp32 accumulation,
    returned as ``out_dtype`` (one rounding of the fp32 sum).
    Differentiable (``_Matmul``); without autograd recording it is the
    same product."""
    lead = x.shape[:-1]
    x2 = cast_compute(x).reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _Matmul.apply(x2, w)
    elif x2.is_cuda and out_dtype != torch.float32:
        y = torch.mm(x2, cast_compute(w))      # one rounding, in cuBLAS
    else:
        y = _mm_f32(x2, cast_compute(w))
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


def sinusoidal_pos(positions, d_model: int):
    """(..., S) int positions -> (..., S, d_model) fp32 table (musicgen):
    ``[sin, cos]`` halves of position x 10000^(-i / half)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------- init, conv and recurrences
def dense_init(generator: torch.Generator, shape, fan_in: int, device):
    """Weights ~ N(0, 1/fan_in), the reference's ``dense_init`` scale."""
    return torch.randn(tuple(shape), generator=generator,
                       device=device) / math.sqrt(fan_in)


def causal_conv1d(x, w, b):
    """Depthwise causal conv over (b, l, ch) with taps w (K, ch): fp32 sums
    tap by tap from zero, then the bias, the result in x's dtype (the
    reference's unrolled taps)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + L].float() * w[k].float()
    return (out + b.float()).to(x.dtype)


def linear_scan(a, b, dim: int):
    """h_t = a_t * h_{t-1} + b_t along ``dim`` from h_{-1} = 0, all t at
    once: a log-depth doubling scan (ceil(log2 T) steps, each composing
    every element with the one ``offset`` before it), the counterpart of
    the reference's ``jax.lax.associative_scan``. ``a`` broadcasts against
    ``b`` in every other dimension; both fp32. Sums in another order than
    a sequential loop: fp32 rounding, not bit equality."""
    n = b.shape[dim]
    off = 1
    while off < n:
        head_a, head_b = a.narrow(dim, 0, off), b.narrow(dim, 0, off)
        prev_a, prev_b = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        cur_a, cur_b = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        b = torch.cat([head_b, cur_b + cur_a * prev_b], dim=dim)
        a = torch.cat([head_a, cur_a * prev_a], dim=dim)
        off *= 2
    return b


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) at every x (torch's own switches
    to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------ logits
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


def _band_attention(q, k, v, cfg, window: int, chunk: int,
                    impl: Optional[str]):
    """The sliding-window kernel (``ops.sliding_window_attention``) as
    prefill attention, (B,S,H,D) bf16. While autograd records a graph
    through q, k or v it runs as ``models.flash.flash_attention``: the same
    forward, which also writes its log-sum-exp, and the flash backward
    kernel (the reference's custom VJP). Serving calls it without, as
    before: no log-sum-exp is written. Under hints that shard the
    sequence (``seq_shards``), each shard of the query rows runs at its
    offset against the whole K and V, in shard order."""
    S, H, KV = q.shape[1], q.shape[2], k.shape[2]
    shards = seq_shards(S, H, KV)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash.flash_attention(q, k, v, window=window, chunk=chunk,
                                     softcap=cfg.attn_logit_softcap,
                                     impl=impl, shards=shards)
    if shards == 1:
        return ops.sliding_window_attention(
            q, k, v, window=window, chunk=chunk,
            softcap=cfg.attn_logit_softcap, impl=impl).to(COMPUTE_DTYPE)
    n = S // shards
    return torch.cat([ops.sliding_window_attention(
        q[:, i * n:(i + 1) * n], k, v, window=window, chunk=chunk,
        softcap=cfg.attn_logit_softcap, impl=impl, q_offset=i * n).to(
            COMPUTE_DTYPE) for i in range(shards)], 1)


def full_causal_attention(q, k, v, cfg, impl: Optional[str] = None):
    """Causal prefill attention through the sliding window with window S
    (the reference's ``_flash_call`` onto ``models/flash.py``): the CUDA
    kernel on the card, its plain version (flash's numerics and block
    schedule) on the CPU. q (B,S,H,D); k, v (B,S,KV,D) -> (B,S,H,D) bf16."""
    return _band_attention(q, k, v, cfg, q.shape[1], 0, impl)


def local_attention(q, k, v, cfg, impl: Optional[str] = None):
    """Sliding-window causal attention with window ``cfg.window_size``;
    causal when the sequence fits in the window, as in the reference."""
    w = cfg.window_size
    if q.shape[1] <= w:
        return full_causal_attention(q, k, v, cfg, impl)
    return _band_attention(q, k, v, cfg, w, 0, impl)


def chunked_attention(q, k, v, cfg, impl: Optional[str] = None):
    """llama4's chunked attention: causal within chunks of
    ``cfg.chunk_size`` positions (a query at p sees the keys t <= p with
    t // c == p // c); plain causal when the sequence fits in one chunk,
    as in the reference."""
    c = cfg.chunk_size
    if q.shape[1] <= c:
        return full_causal_attention(q, k, v, cfg, impl)
    return _band_attention(q, k, v, cfg, q.shape[1], c, impl)


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


def cross_attention(params, x, cond, cfg):
    """Attention of x (B,S,d) to a conditioning sequence cond (B,T,d), all
    T positions visible (no mask, softcap or RoPE): q, k and v rounded to
    bf16 from fp32 sums, fp32 scores scaled by 1/sqrt(D) and softmax, the
    probabilities rounded to bf16 before the context product, as the
    reference orders it. ``wk``/``wv`` are (d, H, D). Returns (B,S,d)
    bf16."""
    H, D = cfg.num_heads, cfg.head_dim

    def heads(t, w):
        y = matmul(t, params[w].reshape(params[w].shape[0], H * D))
        return y.reshape(t.shape[:-1] + (H, D)).to(COMPUTE_DTYPE)

    q, k, v = heads(x, "wq"), heads(cond, "wk"), heads(cond, "wv")
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    p = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
    ctx = torch.einsum("bhst,bthk->bshk", p.float(), v.float())
    return attn_out(params, ctx.to(COMPUTE_DTYPE))


# ---------------------------------------------------------------------- MLP
def _packed_proj(x, packed, n_out: int, plan=None,
                 activation: Optional[str] = None, impl: Optional[str] = None):
    """(B,S,d) · packed BCSC weight -> (B,S,n_out) fp32 via the sparse
    kernels (GEMV arm at decode M, GEMM arm otherwise)."""
    B, S, d = x.shape
    y = ops.bcsc_apply_packed(x.reshape(B * S, d), packed, n_out=n_out,
                              plan=plan, activation=activation, impl=impl)
    return y.reshape(B, S, n_out)


def mlp(params, x, cfg, plan=None, d_ff: Optional[int] = None,
        impl: Optional[str] = None):
    """Gated (SwiGLU/GeGLU) or plain MLP. When every projection is packed
    and the plan routes M = B·S 'fused', the whole MLP is one fused sparse
    kernel; packed projections otherwise take the two-call sparse arm, and
    dense ones the bf16 matmuls. ``plan`` None routes by the active plan,
    else by the ``core.dataflow`` rule (``core.plan.route_mlp``). ``impl``
    is passed on to ``kernels.ops``."""
    act_name = "silu" if cfg.mlp_act == "silu" else "gelu"
    ff = d_ff or (cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff)
    d = x.shape[-1]
    B, S, _ = x.shape

    def act(t):
        return F.silu(t) if cfg.mlp_act == "silu" \
            else F.gelu(t, approximate="tanh")

    names = ("wg", "wu", "wd") if cfg.mlp_gated else ("w1", "w2")
    if all(ops.is_packed(params[n]) for n in names) and plan_lib.route_mlp(
            B * S, ff, d, gated=cfg.mlp_gated, plan=plan) == "fused":
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
