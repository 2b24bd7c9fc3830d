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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


class FlashAttention(torch.autograd.Function):
    """q (B,S,H,D), k, v (B,S,KV,D) bf16 -> out (B,S,H,D) bf16."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, softcap: float,
                impl: Optional[str]):
        out, lse = ops.sliding_window_attention(
            q, k, v, window=window, chunk=chunk, softcap=softcap, impl=impl,
            return_lse=True)
        out16 = out.to(torch.bfloat16)
        ctx.save_for_backward(q, k, v, out16, lse)
        ctx.args = dict(window=window, chunk=chunk, softcap=softcap,
                        impl=impl)
        return out16

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out16, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_backward(q, k, v, out16, lse, dout,
                                        **ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q, k, v, *, window: int, chunk: int = 0,
                    softcap: float = 0.0, impl: Optional[str] = None):
    """Differentiable causal (``window >= S``), sliding-window or chunked
    (``chunk`` > 0, with ``window >= S``) GQA attention, bf16 out.
    ``impl="plain"`` forces the plain versions (comparisons on the card)."""
    return FlashAttention.apply(q, k, v, window, chunk, float(softcap or 0.0),
                                impl)
