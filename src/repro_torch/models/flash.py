"""Attention with a hand-written backward: the port's counterpart of
``repro.models.flash``'s custom VJP.

The reference differentiates its prefill attention through a
``jax.custom_vjp`` that saves only (q, k, v, the bf16 output, its
log-sum-exp) and recomputes the probability blocks in the backward
(``_bwd_impl``): O(S) residuals instead of the S x S probabilities.
:class:`FlashAttention` is the same trade as a ``torch.autograd.Function``:
its forward is the sliding-window kernel (``ops.sliding_window_attention``
with ``return_lse=True``; causal, window or chunk mode, optional tanh
softcap), its backward the flash backward kernel
(``ops.flash_backward``); on the CPU both are their plain versions, which
repeat the reference's block schedule. The gradients come back in the
inputs' dtype (bf16), as the reference's do.

Sequence sharding (the reference's ``layers._flash_call`` under
``shard_map``, where the head counts do not divide the model axis): with
``shards`` n > 1 the query rows are cut into n equal slices, and each runs
both kernels at its global offset (``q_offset``) against the whole K and
V, in shard order, as the model axis's devices would. The forward rows
and dq are each shard's own; dK and dV are the shards' fp32 shares summed
in shard order and cast once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


class FlashAttention(torch.autograd.Function):
    """q (B,S,H,D), k, v (B,S,KV,D) bf16 -> out (B,S,H,D) bf16."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, softcap: float,
                impl: Optional[str], shards: int):
        n = q.shape[1] // shards
        outs, lses = [], []
        for i in range(shards):
            out, lse = ops.sliding_window_attention(
                q[:, i * n:(i + 1) * n], k, v, window=window, chunk=chunk,
                softcap=softcap, impl=impl, return_lse=True, q_offset=i * n)
            outs.append(out.to(torch.bfloat16))
            lses.append(lse)
        out16 = outs[0] if shards == 1 else torch.cat(outs, 1)
        lse = lses[0] if shards == 1 else torch.cat(lses, 1)
        ctx.save_for_backward(q, k, v, out16, lse)
        ctx.args = dict(window=window, chunk=chunk, softcap=softcap,
                        impl=impl)
        ctx.shards = shards
        return out16

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out16, lse = ctx.saved_tensors
        n = q.shape[1] // ctx.shards
        dqs, dk, dv = [], None, None
        for i in range(ctx.shards):
            rows = slice(i * n, (i + 1) * n)
            dq_i, dk_i, dv_i = ops.flash_backward(
                q[:, rows], k, v, out16[:, rows], lse[:, rows],
                dout[:, rows], q_offset=i * n, **ctx.args)
            dqs.append(dq_i)
            dk = dk_i if dk is None else dk.add_(dk_i)
            dv = dv_i if dv is None else dv.add_(dv_i)
        dq = dqs[0] if ctx.shards == 1 else torch.cat(dqs, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def flash_attention(q, k, v, *, window: int, chunk: int = 0,
                    softcap: float = 0.0, impl: Optional[str] = None,
                    shards: int = 1):
    """Differentiable causal (``window >= S``), sliding-window or chunked
    (``chunk`` > 0, with ``window >= S``) GQA attention, bf16 out, over
    ``shards`` sequence shards of the query rows (S a multiple of it).
    ``impl="plain"`` forces the plain versions (comparisons on the card)."""
    if q.shape[1] % shards:
        raise ValueError(f"{q.shape[1]} query rows in {shards} shards")
    return FlashAttention.apply(q, k, v, window, chunk, float(softcap or 0.0),
                                impl, shards)
