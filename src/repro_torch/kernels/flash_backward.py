"""The backward of causal, sliding-window and chunked GQA attention: the
port's counterpart of ``repro.models.flash._bwd_impl``, the backward half
of the reference's custom VJP (its forward is the sliding-window kernel,
``kernels/local_attention.py``, which also writes the log-sum-exp).

No TPU kernel stands behind it: the reference computes it in XLA, and the
port needs its own because autograd cannot see through the forward's
ctypes launch. Given q (B,S,H,D), k, v (B,S,KV,D) bf16, the forward's bf16
output ``out16`` and fp32 log-sum-exp (B,S,H), and the output's cotangent
``dout`` (B,S,H,D) bf16, it returns fp32 dq (B,S,H,D), dk and dv
(B,S,KV,D), with the reference's numerics:

* ``Drow = rowsum(dout · out16)`` in fp32 over the bf16 output;
* the probabilities recomputed from the log-sum-exp, p = exp(s - lse)
  where the mask keeps a score (s tanh-capped when a softcap is set);
* dP = dout · vᵀ in fp32; ds = p (dP - Drow), times 1 - t² under a cap;
* p and ds rounded to bf16 before their products (dv += pᵀ dout, dq +=
  ds k, dk += dsᵀ q), which accumulate in fp32; dq and dk scaled by
  1/sqrt(D).

``flash_backward_plain`` repeats ``_bwd_impl``'s block schedule (flash's
blocks of ``block_size(S)`` tokens, the kv blocks of each q block in
flash's order, ``local_attention.band_schedule``) and its order of fp32
sums, so on the CPU it matches the reference to fp32 rounding.
``flash_backward_cuda`` launches ``csrc/flash_backward.cu``.

On the card the function is bound by operations: 5 products of 2·D
flops per (query, key) pair of the band and head (QKᵀ and dO·Vᵀ
recomputed, dV, dQ, dK), ~2.5x the forward's. The kernel (``mma.sync``
bf16 tiles, fp32 accumulators in registers) runs a small pass for Drow,
then one block per (64 positions, query head, batch row) for dq, walking
the band's key tiles, and one per (64 keys, query head, batch row) for
each head's share of dk and dv, walking the band's q tiles; a last pass
sums the R heads of each KV head in head order. Every sum is taken in
a fixed order: no atomics, the same bits every run. Head dims above 128
run in parts of 128 columns, each part recomputing the scores.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.local_attention import (
    NEG_INF, _check_shapes, _score_mult, band_mask, band_schedule,
    block_is_empty)

TILE = 64            # positions of a dq block, keys of a dk/dv block
PART = 128           # head-dim columns per part of the kernel's outputs


def launch_config(B: int, S: int, H: int, KV: int, D: int) -> dict:
    """The kernels' grids for these shapes, as ``csrc/flash_backward.cu``
    computes them: blocks of 128 threads (4 warps of 16 rows) over (64-row
    tile, query head x column part, batch row) for dq and for each head's
    share of dk / dv; columns in parts of ``PART`` (one of 64 at D <= 64);
    each block's shared memory (six 64-row tiles of D padded to the parts,
    rows padded by 16 bytes, and the staged log-sum-exp and Drow)."""
    tiles = -(-S // TILE)
    dpad = 64 if D <= 64 else -(-D // PART) * PART
    parts = 1 if D <= 64 else dpad // PART
    return dict(threads=128, blocks=tiles * H * parts * B, parts=parts,
                smem_bytes=6 * TILE * (dpad + 8) * 2 + 4 * TILE * 4,
                reduce_heads=H // KV)


def band_flops(S: int, window: int, chunk: int, H: int, D: int,
               B: int = 1) -> int:
    """The backward's flops over the band: 10·D per (query, key) pair of
    the band and head (QKᵀ and dO·Vᵀ recomputed, then dV, dQ and dK, each
    2·D)."""
    if chunk:
        full, rem = divmod(S, chunk)
        pairs = full * chunk * (chunk + 1) // 2 + rem * (rem + 1) // 2
    else:
        w = min(window, S)
        pairs = S * (S + 1) // 2 - (S - w) * (S - w + 1) // 2
    return 10 * D * pairs * H * B


def flash_backward_plain(q, k, v, out16, lse, dout, *, window: int,
                         softcap: float = 0.0, chunk: int = 0):
    """fp32 (dq (B,S,H,D), dk, dv (B,S,KV,D)), ``_bwd_impl``'s schedule."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    R = H // KV
    blk, nb, noff, causal = band_schedule(S, window, chunk)
    pad = nb * blk - S
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    capped = bool(softcap) and softcap > 0.0
    mult = _score_mult(D, softcap)

    def heads(t):                                    # (B,KV,R,Sp,D)
        return F.pad(t.reshape(B, S, KV, R, D).permute(0, 2, 3, 1, 4),
                     (0, 0, 0, pad))

    def keys(t):                                     # (B,KV,Sp,D)
        return F.pad(t.permute(0, 2, 1, 3), (0, 0, 0, pad))

    qp, op, dop = heads(q), heads(out16), heads(dout).float()
    lsep = F.pad(lse.reshape(B, S, KV, R).permute(0, 2, 3, 1), (0, pad))
    kp, vp = keys(k), keys(v)
    drow = (dop * op.float()).sum(-1)                        # (B,KV,R,Sp)
    dk = torch.zeros((B, KV, nb * blk, D), device=dev)
    dv = torch.zeros_like(dk)
    dq = torch.empty((B, KV, R, nb * blk, D), device=dev)
    ar = torch.arange(blk, device=dev)
    for i in range(nb):
        rows = slice(i * blk, (i + 1) * blk)
        qi, oi, li, di = qp[:, :, :, rows], dop[:, :, :, rows], \
            lsep[:, :, :, rows], drow[:, :, :, rows]
        qpos = i * blk + ar
        dqi = torch.zeros((B, KV, R, blk, D), device=dev)
        for r in range(noff):
            j_log = r if causal else i - r
            if block_is_empty(i, j_log, blk, S, window, chunk, causal):
                continue
            lo = j_log * blk
            kj, vj = kp[:, :, lo:lo + blk], vp[:, :, lo:lo + blk]
            x = torch.einsum("bgrqd,bgkd->bgrqk", qi.float(),
                             kj.float()) * mult
            if capped:
                t = torch.tanh(x)
                s = t * softcap
            else:
                s = x
            msk = band_mask(qpos, lo + ar, S, window, chunk, causal)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            p = torch.where(s > NEG_INF / 2, torch.exp(s - li[..., None]),
                            torch.zeros_like(s))
            dp = torch.einsum("bgrqd,bgkd->bgrqk", oi, vj.float())
            ds = p * (dp - di[..., None])
            if capped:
                ds = ds * (1.0 - torch.square(t))
            ds = torch.where(msk, ds, torch.zeros_like(ds))
            ds16 = ds.to(torch.bfloat16).float()
            p16 = p.to(torch.bfloat16).float()
            dqi = dqi + scale * torch.matmul(
                ds16, kj[:, :, None].to(torch.bfloat16).float())
            dk[:, :, lo:lo + blk] += scale * torch.einsum(
                "bgrqk,bgrqd->bgkd", ds16, qi.to(torch.bfloat16).float())
            dv[:, :, lo:lo + blk] += torch.einsum(
                "bgrqk,bgrqd->bgkd", p16, oi.to(torch.bfloat16).float())
        dq[:, :, :, rows] = dqi
    dq = dq[:, :, :, :S].permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return (dq, dk[:, :, :S].permute(0, 2, 1, 3),
            dv[:, :, :S].permute(0, 2, 1, 3))


def flash_backward_cuda(q, k, v, out16, lse, dout, *, window: int,
                        softcap: float = 0.0, chunk: int = 0):
    """The same function through the CUDA kernel: contiguous bf16 q, k, v,
    out16 and dout and fp32 lse on the card, H // KV at most 64, head dim
    a multiple of 16 up to 256. Returns fp32 (dq, dk, dv)."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H // KV > 64 or D % 16 or D > 256 or window < 1 or chunk < 0:
        raise ValueError(f"the kernel takes H // KV up to 64, head_dim a "
                         f"multiple of 16 up to 256, a window >= 1 and a "
                         f"chunk >= 0; got H {H}, KV {KV}, D {D}, window "
                         f"{window}, chunk {chunk}")
    if out16.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, S, H):
        raise ValueError(f"out16 {tuple(out16.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"against q {tuple(q.shape)}")
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                        ("v", v, torch.bfloat16),
                        ("out16", out16, torch.bfloat16),
                        ("dout", dout, torch.bfloat16),
                        ("lse", lse, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dt} CUDA tensor, got {t.dtype} on "
                             f"{t.device}")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, D), **f32)
    dk = torch.empty((B, S, KV, D), **f32)
    dv = torch.empty((B, S, KV, D), **f32)
    drow = torch.empty((B, S, H), **f32)
    dk_part = torch.empty((B, S, H, D), **f32)
    dv_part = torch.empty((B, S, H, D), **f32)
    code = _build.library().repro_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out16.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), drow.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), B, S, H, KV, D, min(window, S), chunk,
        _score_mult(D, softcap), float(softcap or 0.0),
        1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(code, "flash_backward")
    flash_backward_cuda.launches += 1
    return dq, dk, dv


flash_backward_cuda.launches = 0
