"""Causal sliding-window GQA attention, the port's prefill attention.

Counterpart of ``repro.kernels.local_attention`` (the Pallas band kernel
``sliding_window_attention_raw``, body ``_swa_kernel``) and of the prefill forward of ``repro.models.flash``, which compute the same
function: a query at position p attends to the keys at positions t with
``0 <= p - t < window``. ``window >= S`` is plain causal attention, so one
kernel serves the local layers of gemma2 and every global layer's prefill.
A ``chunk`` c > 0 (with ``window >= S``) adds ``t // c == p // c``: llama4's
chunked attention, flash's chunk mode.

``sliding_window_attention_plain`` repeats ``flash._fwd_impl``'s numerics and
block schedule (``band_schedule``): blocks of ``block_size(S)`` tokens, fp32 scores scaled by
``1/sqrt(D)`` and optionally tanh-capped (``_score_mult``), an fp32 online
softmax (NEG_INF = -2e38, p = exp(s - m) only where s > NEG_INF / 2,
out = acc / max(l, 1e-30)) and p and v rounded to bf16 for the PV product
with fp32 accumulation. kv blocks are visited in flash's order (ascending in
causal mode, descending from the diagonal in window and chunk mode, as many
as flash's ``_offsets`` gives), so its fp32 sums are the reference's.
Blocks that the mask empties entirely are skipped: they leave (m, l, acc)
exactly as they were. ``sliding_window_attention_cuda`` launches the
hand-written kernel in ``csrc/local_attention.cu``.

On the card the function is bound by operations (4·D flops per (query, key)
pair and head), which only ``wgmma`` reaches: the kernel runs one warpgroup
per 64-row tile of (position, head) rows (``64 // R`` positions x the R heads
of a KV head, for any R up to 64), two per block sharing K/V tiles
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
    1 KB to align the 128-byte swizzle atoms). A q tile holds ``per_tile``
    positions x the R = H // KV heads of a KV head: its first ``live`` rows;
    the other ``dead_rows`` (when R does not divide TILE_ROWS) compute
    nothing that is kept."""
    R = H // KV
    per_tile = TILE_ROWS // R
    nb = -(-D // 64)
    return dict(blocks=-(-S // (WARPGROUPS * per_tile)) * B * KV,
                threads=128 * WARPGROUPS, stages=STAGES, key_tile=KEY_TILE,
                per_tile=per_tile, live=per_tile * R,
                dead_rows=TILE_ROWS - per_tile * R,
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


def band_schedule(S: int, window: int, chunk: int):
    """flash's block schedule for a band: (block, blocks, kv blocks a q
    block visits, causal). A q block ``i`` visits kv blocks ``r`` (causal)
    or ``i - r`` (window and chunk mode) for r < the third value."""
    causal = window >= S and not chunk
    blk = block_size(S)
    nb = -(-S // blk)
    if causal:
        noff = nb
    elif chunk:
        noff = min(chunk // blk + (1 if chunk % blk else 0) + 1, nb)
    else:
        noff = min((window - 1 + blk) // blk + 1, nb)
    return blk, nb, noff, causal


def band_mask(qpos, kpos, S: int, window: int, chunk: int, causal: bool):
    """flash's ``_mask`` over (q positions, key positions)."""
    msk = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < S) \
        & (qpos[:, None] < S)
    if chunk:
        msk &= (qpos[:, None] // chunk) == (kpos[None, :] // chunk)
    elif not causal:
        msk &= (qpos[:, None] - kpos[None, :]) < window
    return msk


def block_is_empty(i: int, j_log: int, blk: int, S: int, window: int,
                   chunk: int, causal: bool) -> bool:
    """Whether the mask empties kv block ``j_log`` for q block ``i``:
    then the online softmax leaves (m, l, acc) as they were and the
    backward adds exact zeros, so both skip it."""
    lo = j_log * blk
    first = i * blk // chunk * chunk if chunk else i * blk - window + 1
    return lo > min(i * blk + blk - 1, S - 1) or lo + blk - 1 < 0 or (
        not causal and lo + blk - 1 < first)


def sliding_window_attention_plain(q, k, v, *, window: int,
                                   softcap: float = 0.0, chunk: int = 0,
                                   return_lse: bool = False):
    """q (B,S,H,D); k, v (B,S,KV,D), head h reading KV head h // (H // KV).
    Returns (B,S,H,D) fp32; causal when ``window >= S``, causal within
    chunks of ``chunk`` positions when that is > 0. With ``return_lse``
    also the log-sum-exp of each row's scores, (B,S,H) fp32 in natural-log
    units, flash's ``m + log(max(l, 1e-30))``."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    R = H // KV
    if chunk and window < S:
        raise ValueError(f"chunk {chunk} takes a window >= S, got {window}")
    blk, nb, noff, causal = band_schedule(S, window, chunk)
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
    lse = torch.empty((B, KV, R, nb * blk), device=dev)
    ar = torch.arange(blk, device=dev)
    for i in range(nb):
        qpos = i * blk + ar
        qi = qf[:, :, :, i * blk:(i + 1) * blk]
        m = torch.full((B, KV, R, blk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, R, blk), device=dev)
        acc = torch.zeros((B, KV, R, blk, D), device=dev)
        for r in range(noff):
            j_log = r if causal else i - r
            if block_is_empty(i, j_log, blk, S, window, chunk, causal):
                continue
            lo = j_log * blk
            kpos = lo + ar
            s = torch.einsum("bgrqd,bgkd->bgrqk", qi,
                             kf[:, :, lo:lo + blk]) * mult
            if capped:
                s = torch.tanh(s) * softcap
            msk = band_mask(qpos, kpos, S, window, chunk, causal)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(torch.bfloat16).float(), vf[:, :, None, lo:lo + blk])
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, :, :, i * blk:(i + 1) * blk] = acc / l_safe[..., None]
        lse[:, :, :, i * blk:(i + 1) * blk] = m + torch.log(l_safe)
    out = out[:, :, :, :S].permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    if not return_lse:
        return out
    return out, lse[:, :, :, :S].permute(0, 3, 1, 2).reshape(B, S, H)


def sliding_window_attention_cuda(q, k, v, *, window: int,
                                  softcap: float = 0.0, chunk: int = 0,
                                  return_lse: bool = False):
    """The same function through the CUDA kernel: bf16 q, k, v on the card,
    at most 256 head dimensions (a multiple of 16) and H // KV at most 64
    (a ratio that does not divide 64 leaves each tile's last
    ``TILE_ROWS % (H // KV)`` rows dead). Returns (B,S,H,D) fp32, and with
    ``return_lse`` the (B,S,H) fp32 log-sum-exp (the kernel writes it only
    when given the pointer)."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H // KV > TILE_ROWS or D % 16 or D > 256 or window < 1 or chunk < 0:
        raise ValueError(f"the kernel takes H // KV up to {TILE_ROWS}, "
                         f"head_dim a multiple of 16 up to 256, a window "
                         f">= 1 and a chunk >= 0; got H {H}, KV {KV}, D {D}, "
                         f"window {window}, chunk {chunk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    code = _build.library().repro_sliding_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.ptr(lse), B, S, H, KV, D, min(window, S), chunk,
        _score_mult(D, softcap), float(softcap or 0.0), _build.stream_of(q))
    _build.check(code, "sliding_window_attention")
    sliding_window_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


sliding_window_attention_cuda.launches = 0
