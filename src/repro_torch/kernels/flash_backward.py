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

q may hold a slice of the rows, at positions ``q_offset`` .. of k and v's
(the reference's sequence-sharded call): dq is then the slice's rows, dk
and dv the slice's share of the keys' gradients, which the shards' sum
completes (``models.flash``). ``flash_backward_plain`` repeats
``_bwd_impl``'s block schedule (flash's
blocks of ``block_size(S)`` tokens, the kv blocks of each q block in
flash's order, ``local_attention.band_schedule``) and its order of fp32
sums, so on the CPU it matches the reference to fp32 rounding.
``flash_backward_cuda`` launches ``csrc/flash_backward.cu``.

On the card the function is bound by operations: 5 products of 2·D
flops per (query, key) pair of the band and head (QKᵀ and dO·Vᵀ
recomputed, dV, dQ, dK), ~2.5x the forward's. Every product runs on
``wgmma`` from tiles that TMA brings into shared memory
(``launch_config`` gives the grids). The dq kernel is the forward's
block: a consumer warpgroup owns 64 (position, query head) rows, 64 // R
positions x the R heads of one KV head, so each K/V tile, which a
producer warp loads, serves all R heads; it walks the band's key tiles,
after writing its rows' Drow and lse·log2(e) by head for the next
kernel. The dk/dv kernel
gives a block 64 keys of one KV head; it walks the band's q tiles for
each query head of its group in head order, dK and dV summed across the
heads in registers; its warpgroups take the steps in turn (their own
stages, turns to issue the scores' products), or above D 128 share each
step with half of dK and dV's columns each. When B·KV·⌈Sk/64⌉ blocks do
not fill the card, the R heads are cut into ``groups`` groups, each
writing one fp32 share that a last pass adds in group order. The mask
runs only on a tile's edges (interior tiles run a loop compiled without
it). Every sum is taken in a fixed order: no atomics, the same bits
every run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.local_attention import (
    NEG_INF, _check_shapes, _score_mult, band_mask, band_schedule,
    meta_products, visited_keys)

TILE = 64            # rows of a tile: (position, head) pairs, keys, positions
SMEM_LIMIT = 232448  # bytes of shared memory a block may have on an H100
SM_COUNT = 132       # the H100's SMs: the default of ``launch_config``


def launch_config(B: int, S: int, H: int, KV: int, D: int, *,
                  window: int | None = None, chunk: int = 0,
                  q_offset: int = 0, Sq: int | None = None,
                  sms: int = SM_COUNT) -> dict:
    """The kernels' launch for these shapes (S keys; the Sq query rows at
    ``q_offset``, all S by default), as ``csrc/flash_backward.cu`` computes
    it from the arguments it is given:

    * dq: ``dq_wgs`` consumer warpgroups (3 at D <= 64, 2 at D <= 128,
      else 1) and a producer warp, each warpgroup owning 64 // R
      positions x R heads, so a block holds ``dq_tile`` positions;
      ``dq_stages`` K/V stages;
    * dk/dv: ``dkv_wgs`` consumer warpgroups (3 at D <= 64, else 2) that
      take the steps in turn through ``dkv_stages`` stages, kept apart
      (both take every step at D > 128, ``dkv_split``, splitting dK and
      dV's columns), a block per (64 keys, group, batch row, KV head);
      ``groups`` is the least divisor of R (below R when R > 1) at which
      the blocks whose keys meet the slice's band reach ``sms``, else the
      largest such divisor;
    * each kernel's dynamic shared memory (``*_smem_bytes``) and the fp32
      scratch the wrapper allocates (``ws_floats``: lse·log2(e) and Drow
      by head, then the groups' dk and dv shares when groups > 1)."""
    R = H // KV
    Sq = S if Sq is None else Sq
    window = S if window is None else min(window, S)
    nb = -(-D // 64)
    blk = TILE * 128                 # one 64 x 64 bf16 block of a tile
    dq_wgs = 3 if nb == 1 else 2 if nb == 2 else 1
    dq_stages = 4 if nb <= 2 else 2
    dq_tile = dq_wgs * (TILE // R)
    split = nb > 2
    nb_kv = 4 if split else nb       # the split pads D to 256
    dkv_wgs = 3 if nb == 1 else 2
    dkv_stages = 2 if split else dkv_wgs * (4 if nb == 1 else 2)
    # key tiles whose band meets the slice's rows
    q_end = q_offset + Sq
    first = max(0, q_offset - window + 1)
    if chunk:
        first = max(first, q_offset // chunk * chunk)
    active = (q_end - 1) // TILE - first // TILE + 1
    divs = [d for d in range(1, R + 1) if R % d == 0 and (d < R or R == 1)]
    groups = next((d for d in divs if B * KV * active * d >= sms), divs[-1])
    sqp = -(-Sq // TILE) * TILE
    return dict(
        dq_threads=128 * dq_wgs + 32, dq_wgs=dq_wgs, dq_stages=dq_stages,
        dq_tile=dq_tile, dq_blocks=-(-Sq // dq_tile) * B * KV,
        dq_smem_bytes=(3 * dq_wgs + 2 * dq_stages) * nb * blk + 1024,
        dkv_threads=128 * dkv_wgs, dkv_wgs=dkv_wgs, dkv_stages=dkv_stages,
        dkv_split=split,
        groups=groups, dkv_blocks=-(-S // TILE) * groups * B * KV,
        dkv_smem_bytes=(2 + 2 * dkv_stages) * nb_kv * blk
        + dkv_stages * 2 * TILE * 4 + (64 * 128 * 4 if split else 0) + 1024,
        ws_floats=2 * B * H * sqp
        + (2 * groups * B * S * KV * D if groups > 1 else 0))


def band_pairs(S: int, window: int, chunk: int, q_offset: int = 0,
               Sq: int = 0) -> int:
    """(query, key) pairs of the band for the Sq rows (all S when 0) at
    positions q_offset..: a row at p sees min(p + 1, window) keys, or p %
    chunk + 1 in chunk mode."""
    def upto(n):                   # the pairs of the rows before n
        if chunk:
            full, rem = divmod(n, chunk)
            return full * chunk * (chunk + 1) // 2 + rem * (rem + 1) // 2
        w = min(window, S)
        return n * (n + 1) // 2 if n <= w else \
            w * (w + 1) // 2 + (n - w) * w
    return upto(q_offset + (Sq or S)) - upto(q_offset)


def band_flops(S: int, window: int, chunk: int, H: int, D: int,
               B: int = 1, q_offset: int = 0, Sq: int = 0) -> int:
    """The backward's flops over the band (of the Sq rows at q_offset, as
    ``band_pairs``): 10·D per (query, key) pair of the band and head (QKᵀ
    and dO·Vᵀ recomputed, then dV, dQ and dK, each 2·D)."""
    return 10 * D * band_pairs(S, window, chunk, q_offset, Sq) * H * B


def flash_backward_plain(q, k, v, out16, lse, dout, *, window: int,
                         softcap: float = 0.0, chunk: int = 0,
                         q_offset: int = 0):
    """fp32 (dq (B,Sq,H,D), dk, dv (B,Sk,KV,D)), ``_bwd_impl``'s schedule,
    for q's rows at positions q_offset .. (all Sk rows by default): dk and
    dv then hold those rows' share."""
    _check_shapes(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    R = H // KV
    qb, kb, nq, causal, visits = band_schedule(Sk, window, chunk, Sq,
                                               q_offset)
    if q.device.type == "meta":
        return _plain_on_meta(q, k, qb, visited_keys(nq, kb, visits))
    qpad, kpad = nq * qb - Sq, -(-Sk // kb) * kb - Sk
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    capped = bool(softcap) and softcap > 0.0
    mult = _score_mult(D, softcap)

    def heads(t):                                    # (B,KV,R,Sqp,D)
        return F.pad(t.reshape(B, Sq, KV, R, D).permute(0, 2, 3, 1, 4),
                     (0, 0, 0, qpad))

    def keys(t):                                     # (B,KV,Skp,D)
        return F.pad(t.permute(0, 2, 1, 3), (0, 0, 0, kpad))

    qp, op, dop = heads(q), heads(out16), heads(dout).float()
    lsep = F.pad(lse.reshape(B, Sq, KV, R).permute(0, 2, 3, 1), (0, qpad))
    kp, vp = keys(k), keys(v)
    drow = (dop * op.float()).sum(-1)                        # (B,KV,R,Sqp)
    dk = torch.zeros((B, KV, Sk + kpad, D), device=dev)
    dv = torch.zeros_like(dk)
    dq = torch.empty((B, KV, R, nq * qb, D), device=dev)
    aq, ak = torch.arange(qb, device=dev), torch.arange(kb, device=dev)
    for i in range(nq):
        rows = slice(i * qb, (i + 1) * qb)
        qi, oi, li, di = qp[:, :, :, rows], dop[:, :, :, rows], \
            lsep[:, :, :, rows], drow[:, :, :, rows]
        qpos = q_offset + i * qb + aq
        dqi = torch.zeros((B, KV, R, qb, D), device=dev)
        for lo in visits(i):
            kj, vj = kp[:, :, lo:lo + kb], vp[:, :, lo:lo + kb]
            x = torch.einsum("bgrqd,bgkd->bgrqk", qi.float(),
                             kj.float()) * mult
            if capped:
                t = torch.tanh(x)
                s = t * softcap
            else:
                s = x
            msk = band_mask(qpos, lo + ak, Sk, window, chunk, causal,
                            q_offset + Sq)
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
            dk[:, :, lo:lo + kb] += scale * torch.einsum(
                "bgrqk,bgrqd->bgkd", ds16, qi.to(torch.bfloat16).float())
            dv[:, :, lo:lo + kb] += torch.einsum(
                "bgrqk,bgrqd->bgkd", p16, oi.to(torch.bfloat16).float())
        dq[:, :, :, rows] = dqi
    dq = dq[:, :, :, :Sq].permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq, dk[:, :, :Sk].permute(0, 2, 1, 3),
            dv[:, :, :Sk].permute(0, 2, 1, 3))


def _plain_on_meta(q, k, qb: int, n: int):
    """The plain version on ``meta`` tensors: dq, dk and dv's shapes, and
    its five products (QKᵀ, dO·Vᵀ, dq, dk, dv) over the ``n`` keys of
    every visited block, the FLOPs of the block loop
    (``local_attention._plain_on_meta``)."""
    B, Sq, H, D = q.shape
    meta_products(5, B * H * qb, n, D)
    dkv = torch.empty(tuple(k.shape), device="meta")
    return torch.empty((B, Sq, H, D), device="meta"), dkv, dkv.clone()


def flash_backward_cuda(q, k, v, out16, lse, dout, *, window: int,
                        softcap: float = 0.0, chunk: int = 0,
                        q_offset: int = 0):
    """The same function through the CUDA kernel: contiguous bf16 q, k, v,
    out16 and dout and fp32 lse on the card, H // KV at most 64, head dim
    a multiple of 16 up to 256. Returns fp32 (dq, dk, dv). Only at a
    ``q_offset`` that is a multiple of ``launch_config``'s ``dq_tile``
    (and a slice a whole number of such tiles) does each dq row have the
    bits of the whole launch; dk and dv are the slice's share."""
    _check_shapes(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H // KV > 64 or D % 16 or D > 256 or window < 1 or chunk < 0:
        raise ValueError(f"the kernel takes H // KV up to 64, head_dim a "
                         f"multiple of 16 up to 256, a window >= 1 and a "
                         f"chunk >= 0; got H {H}, KV {KV}, D {D}, window "
                         f"{window}, chunk {chunk}")
    if out16.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, Sq, H):
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
    window = min(window, Sk)
    lc = launch_config(B, Sk, H, KV, D, window=window, chunk=chunk,
                       q_offset=q_offset, Sq=Sq,
                       sms=_build.sm_count(q.device.index))
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, D), **f32)
    dk = torch.empty((B, Sk, KV, D), **f32)
    dv = torch.empty((B, Sk, KV, D), **f32)
    ws = torch.empty(lc["ws_floats"], **f32)
    code = _build.library().repro_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out16.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr(), B, Sq, Sk, q_offset, H, KV, D, window,
        chunk, lc["groups"], _score_mult(D, softcap), float(softcap or 0.0),
        1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(code, "flash_backward")
    flash_backward_cuda.launches += 1
    return dq, dk, dv


flash_backward_cuda.launches = 0
