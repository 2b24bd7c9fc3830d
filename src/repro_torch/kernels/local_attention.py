"""Causal sliding-window GQA attention, the port's prefill attention.

Counterpart of ``repro.kernels.local_attention`` (the Pallas band kernel
``sliding_window_attention_raw``, body ``_swa_kernel``) and of the prefill forward of ``repro.models.flash``, which compute the same
function: a query at position p attends to the keys at positions t with
``0 <= p - t < window``. ``window >= S`` is plain causal attention, so one
kernel serves the local layers of gemma2 and every global layer's prefill.

``sliding_window_attention_plain`` repeats ``flash._fwd_impl``'s numerics and
block schedule: blocks of ``block_size(S)`` tokens, fp32 scores scaled by
``1/sqrt(D)`` and optionally tanh-capped (``_score_mult``), an fp32 online
softmax (NEG_INF = -2e38, p = exp(s - m) only where s > NEG_INF / 2,
out = acc / max(l, 1e-30)) and p and v rounded to bf16 for the PV product
with fp32 accumulation. kv blocks are visited in flash's order (ascending in
causal mode, descending from the diagonal in window mode), so its fp32 sums
are the reference's.
Blocks that the mask empties entirely are skipped: they leave (m, l, acc)
exactly as they were. ``sliding_window_attention_cuda`` launches the
hand-written kernel in ``csrc/local_attention.cu``.

On the card the function is bound by operations (4·D flops per (query, key)
pair and head), which only ``wgmma`` reaches: the kernel runs one warpgroup
per 64-row tile of (position, head) rows, two per block sharing K/V tiles
fed by a two-stage cp.async ring under mbarriers, S = QKᵀ and O += PV on
wgmma with the scores, p and the 64 x D fp32 accumulator in registers, the
softmax in log2 units, the mask only on the band's edge tiles, and the
longest q tiles launched first. What still holds it back: the softmax's
per-element work (tanhf above all) on the CUDA cores, no producer warp,
and at D 256 one block per SM (``launch_config``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -2.0e38
TILE_ROWS = 64          # (position, head) rows of one warpgroup
WARPGROUPS = 2          # q tiles of one thread block, sharing its K/V tiles
KEY_TILE = 64           # keys per staged K/V tile
STAGES = 2              # K/V tiles in flight


def launch_config(B: int, S: int, H: int, KV: int, D: int) -> dict:
    """The kernel's grid for these shapes, as ``csrc/local_attention.cu``
    computes it: one block of WARPGROUPS x 128 threads per (WARPGROUPS q
    tiles, KV head, batch row), and its shared memory (a Q tile per
    warpgroup plus STAGES K and V tiles, D padded to a multiple of 64, and
    1 KB to align the 128-byte swizzle atoms)."""
    per_block = WARPGROUPS * (TILE_ROWS // (H // KV))
    nb = -(-D // 64)
    return dict(blocks=-(-S // per_block) * B * KV, threads=128 * WARPGROUPS,
                stages=STAGES, key_tile=KEY_TILE,
                smem_bytes=(WARPGROUPS + 2 * STAGES) * nb * 64 * 128 + 1024)


def block_size(S: int) -> int:
    """flash's block: 512 tokens, halved while longer than S, at least 16."""
    blk = 512
    while blk > S:
        blk //= 2
    return max(blk, 16)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,S,H,D) and (B,S,KV,D)")
    B, S, H, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} vs k/v {tuple(k.shape)}")


def _score_mult(D: int, softcap: float) -> float:
    """What q.k is multiplied by before the cap's tanh: 1/sqrt(D), or with a
    softcap the fp32 quotient (1/sqrt(D)) / softcap, the one multiply XLA
    folds flash's ``s * scale / softcap`` into (so the capped scores are the
    reference's)."""
    scale = 1.0 / math.sqrt(D)
    if not softcap or softcap <= 0.0:
        return scale
    return (torch.tensor(scale) / softcap).item()


def sliding_window_attention_plain(q, k, v, *, window: int,
                                   softcap: float = 0.0):
    """q (B,S,H,D); k, v (B,S,KV,D), head h reading KV head h // (H // KV).
    Returns (B,S,H,D) fp32; causal when ``window >= S``."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    R = H // KV
    causal = window >= S
    blk = block_size(S)
    nb = -(-S // blk)
    noff = nb if causal else min((window - 1 + blk) // blk + 1, nb)
    pad = nb * blk - S
    dev = q.device
    qf = F.pad(q.float().reshape(B, S, KV, R, D).permute(0, 2, 3, 1, 4),
               (0, 0, 0, pad))                           # (B,KV,R,Sp,D)
    kf = F.pad(k.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
    vf = F.pad(v.to(torch.bfloat16).float().permute(0, 2, 1, 3),
               (0, 0, 0, pad))                           # (B,KV,Sp,D)
    capped = bool(softcap) and softcap > 0.0
    mult = _score_mult(D, softcap)
    out = torch.empty((B, KV, R, nb * blk, D), device=dev)
    ar = torch.arange(blk, device=dev)
    for i in range(nb):
        qpos = i * blk + ar
        qi = qf[:, :, :, i * blk:(i + 1) * blk]
        m = torch.full((B, KV, R, blk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, R, blk), device=dev)
        acc = torch.zeros((B, KV, R, blk, D), device=dev)
        for r in range(noff):
            j_log = r if causal else i - r
            lo = j_log * blk
            # a block the mask empties is a no-op of the online softmax
            if lo > min(i * blk + blk - 1, S - 1) or lo + blk - 1 < 0 or (
                    not causal and lo + blk - 1 <= i * blk - window):
                continue
            kpos = lo + ar
            s = torch.einsum("bgrqd,bgkd->bgrqk", qi,
                             kf[:, :, lo:lo + blk]) * mult
            if capped:
                s = torch.tanh(s) * softcap
            msk = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < S) \
                & (qpos[:, None] < S)
            if not causal:
                msk &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(torch.bfloat16).float(), vf[:, :, None, lo:lo + blk])
            m = m_new
        out[:, :, :, i * blk:(i + 1) * blk] = \
            acc / torch.clamp_min(l, 1e-30)[..., None]
    return out[:, :, :, :S].permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def sliding_window_attention_cuda(q, k, v, *, window: int,
                                  softcap: float = 0.0):
    """The same function through the CUDA kernel: bf16 q, k, v on the card,
    at most 256 head dimensions (a multiple of 16) and H // KV dividing
    64. Returns (B,S,H,D) fp32."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if TILE_ROWS % (H // KV) or D % 16 or D > 256 or window < 1:
        raise ValueError(f"the kernel takes H // KV dividing {TILE_ROWS}, "
                         f"head_dim a multiple of 16 up to 256 and a window "
                         f">= 1; got H {H}, KV {KV}, D {D}, window {window}")
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    code = _build.library().repro_sliding_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, D, min(window, S), _score_mult(D, softcap),
        float(softcap or 0.0), _build.stream_of(q))
    _build.check(code, "sliding_window_attention")
    sliding_window_attention_cuda.launches += 1
    return out


sliding_window_attention_cuda.launches = 0
