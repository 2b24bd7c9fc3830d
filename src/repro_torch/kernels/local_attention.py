"""Causal sliding-window GQA attention, the port's prefill attention.

Counterpart of ``repro.kernels.local_attention`` (the Pallas band kernel
``sliding_window_attention_raw``, body ``_swa_kernel``) and of the prefill forward of ``repro.models.flash``, which compute the same
function: a query at position p attends to the keys at positions t with
``0 <= p - t < window``. ``window >= S`` is plain causal attention, so one
kernel serves the local layers of gemma2 and every global layer's prefill.
A ``chunk`` c > 0 (with ``window >= S``) adds ``t // c == p // c``: llama4's
chunked attention, flash's chunk mode. q may hold a slice of the rows:
those at positions ``q_offset`` .. ``q_offset + Sq - 1`` of k and v's
``Sk``, the reference's sequence-sharded attention (flash with ``qpos``
under ``layers._flash_call``'s shard_map), where each shard of the query
rows attends to the whole K and V.

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


def _check_shapes(q, k, v, q_offset: int = 0):
    """q (B,Sq,H,D) holds the rows at positions q_offset .. q_offset + Sq
    - 1 of k, v (B,Sk,KV,D): Sq = Sk at offset 0, or a slice of the rows
    (a sequence shard)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,Sq,H,D) and (B,Sk,KV,D)")
    B, Sq, H, D = q.shape
    if (k.shape[0], k.shape[3]) != (B, D) or H % k.shape[2] \
            or q_offset < 0 or q_offset + Sq > k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} at offset {q_offset} vs k/v "
                         f"{tuple(k.shape)}")


def _score_mult(D: int, softcap: float) -> float:
    """What q.k is multiplied by before the cap's tanh: 1/sqrt(D), or with a
    softcap the fp32 quotient (1/sqrt(D)) / softcap, the one multiply XLA
    folds flash's ``s * scale / softcap`` into (so the capped scores are the
    reference's)."""
    scale = 1.0 / math.sqrt(D)
    if not softcap or softcap <= 0.0:
        return scale
    return (torch.tensor(scale) / softcap).item()


def band_schedule(Sk: int, window: int, chunk: int, Sq: int = 0,
                  q_offset: int = 0):
    """flash's block schedule for the Sq query rows (all Sk when 0) at
    positions q_offset.. against Sk keys: (q block, kv block, q blocks,
    causal, visits). Keys come in blocks of ``block_size(Sk)``; the
    queries in blocks as long, or of ``min(that, Sq)`` for a slice of the
    rows (the reference's sequence-sharded call, ``qpos``). ``visits(i)``
    lists the first key of each kv block q block ``i`` visits, in flash's
    order (ascending in causal mode, descending from the block of the q
    block's last position in window and chunk mode, as many as flash's
    ``_offsets`` gives), without the blocks the mask empties for every
    row of the q block: they leave the online softmax as it was and add
    exact zeros in the backward, so both skip them."""
    Sq = Sq or Sk
    causal = window >= Sk and not chunk
    kb = block_size(Sk)
    qb = kb if Sq == Sk else min(kb, Sq)
    nq, nk = -(-Sq // qb), -(-Sk // kb)
    if causal:
        noff = nk
    elif chunk:
        noff = min(chunk // kb + (1 if chunk % kb else 0) + 1, nk)
    else:
        noff = min((window - 1 + qb) // kb + 1, nk)
    q_end = q_offset + Sq

    def visits(i: int):
        q0 = q_offset + i * qb
        q1 = min(q0 + qb, q_end) - 1
        last = (q0 + qb - 1) // kb
        first = q0 // chunk * chunk if chunk else q0 - window + 1
        out = []
        for r in range(noff):
            lo = (r if causal else last - r) * kb
            if lo > q1 or lo + kb - 1 < 0 or (
                    not causal and lo + kb - 1 < first):
                continue
            out.append(lo)
        return out

    return qb, kb, nq, causal, visits


def band_mask(qpos, kpos, Sk: int, window: int, chunk: int, causal: bool,
              q_end: int = 0):
    """flash's ``_mask`` over (q positions, key positions); query rows at
    or past ``q_end`` (Sk when 0) are padding."""
    msk = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < Sk) \
        & (qpos[:, None] < (q_end or Sk))
    if chunk:
        msk &= (qpos[:, None] // chunk) == (kpos[None, :] // chunk)
    elif not causal:
        msk &= (qpos[:, None] - kpos[None, :]) < window
    return msk


def sliding_window_attention_plain(q, k, v, *, window: int,
                                   softcap: float = 0.0, chunk: int = 0,
                                   return_lse: bool = False,
                                   q_offset: int = 0):
    """q (B,Sq,H,D); k, v (B,Sk,KV,D), head h reading KV head h // (H //
    KV); q's rows are the positions q_offset .. q_offset + Sq - 1 (all Sk
    rows by default). Returns (B,Sq,H,D) fp32; causal when ``window >=
    Sk``, causal within chunks of ``chunk`` positions when that is > 0.
    With ``return_lse`` also the log-sum-exp of each row's scores,
    (B,Sq,H) fp32 in natural-log units, flash's ``m + log(max(l,
    1e-30))``."""
    _check_shapes(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    R = H // KV
    if chunk and window < Sk:
        raise ValueError(f"chunk {chunk} takes a window >= S, got {window}")
    qb, kb, nq, causal, visits = band_schedule(Sk, window, chunk, Sq,
                                               q_offset)
    if q.device.type == "meta":
        return _plain_on_meta(q, qb, kb, nq, visits, return_lse)
    kpad = -(-Sk // kb) * kb - Sk
    dev = q.device
    qf = F.pad(q.float().reshape(B, Sq, KV, R, D).permute(0, 2, 3, 1, 4),
               (0, 0, 0, nq * qb - Sq))                  # (B,KV,R,Sqp,D)
    kf = F.pad(k.float().permute(0, 2, 1, 3), (0, 0, 0, kpad))
    vf = F.pad(v.to(torch.bfloat16).float().permute(0, 2, 1, 3),
               (0, 0, 0, kpad))                          # (B,KV,Skp,D)
    capped = bool(softcap) and softcap > 0.0
    mult = _score_mult(D, softcap)
    out = torch.empty((B, KV, R, nq * qb, D), device=dev)
    lse = torch.empty((B, KV, R, nq * qb), device=dev)
    aq, ak = torch.arange(qb, device=dev), torch.arange(kb, device=dev)
    for i in range(nq):
        qpos = q_offset + i * qb + aq
        qi = qf[:, :, :, i * qb:(i + 1) * qb]
        m = torch.full((B, KV, R, qb), NEG_INF, device=dev)
        l = torch.zeros((B, KV, R, qb), device=dev)
        acc = torch.zeros((B, KV, R, qb, D), device=dev)
        for lo in visits(i):
            s = torch.einsum("bgrqd,bgkd->bgrqk", qi,
                             kf[:, :, lo:lo + kb]) * mult
            if capped:
                s = torch.tanh(s) * softcap
            msk = band_mask(qpos, lo + ak, Sk, window, chunk, causal,
                            q_offset + Sq)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(torch.bfloat16).float(), vf[:, :, None, lo:lo + kb])
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, :, :, i * qb:(i + 1) * qb] = acc / l_safe[..., None]
        lse[:, :, :, i * qb:(i + 1) * qb] = m + torch.log(l_safe)
    out = out[:, :, :, :Sq].permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    if not return_lse:
        return out
    return out, lse[:, :, :, :Sq].permute(0, 3, 1, 2).reshape(B, Sq, H)


def visited_keys(nq: int, kb: int, visits) -> int:
    """Keys the schedule's blocks hold, summed over the q blocks."""
    return kb * sum(len(visits(i)) for i in range(nq))


def meta_products(count: int, rows: int, keys: int, D: int) -> None:
    """``count`` products of 2·rows·keys·D FLOPs each on ``meta``, one
    ``mm`` apiece: what a plain version's block loop multiplies, summed
    over its blocks, for ``torch.utils.flop_counter`` to count."""
    a = torch.empty((rows, D), device="meta")
    b = torch.empty((D, keys), device="meta")
    for _ in range(count):
        torch.mm(a, b)


def _plain_on_meta(q, qb: int, kb: int, nq: int, visits, return_lse: bool):
    """The plain version on ``meta`` tensors: the output shapes, and its
    two products (QKᵀ and PV, 2·D FLOPs a (query row of a block, visited
    key) pair and head each) issued once over every visited block, the
    FLOPs of the block loop (``launch.cell`` counts them). A block loop on
    ``meta`` costs the host as much per operation as one on the CPU: at
    32768 positions, minutes a step."""
    B, Sq, H, D = q.shape
    meta_products(2, B * H * qb, visited_keys(nq, kb, visits), D)
    out = torch.empty((B, Sq, H, D), device="meta")
    return (out, torch.empty((B, Sq, H), device="meta")) if return_lse \
        else out


def sliding_window_attention_cuda(q, k, v, *, window: int,
                                  softcap: float = 0.0, chunk: int = 0,
                                  return_lse: bool = False,
                                  q_offset: int = 0):
    """The same function through the CUDA kernel: bf16 q, k, v on the card,
    at most 256 head dimensions (a multiple of 16) and H // KV at most 64
    (a ratio that does not divide 64 leaves each tile's last
    ``TILE_ROWS % (H // KV)`` rows dead). Returns (B,Sq,H,D) fp32, and with
    ``return_lse`` the (B,Sq,H) fp32 log-sum-exp (the kernel writes it only
    when given the pointer). A ``q_offset`` that is a multiple of the
    block's ``2 * per_tile`` positions (``launch_config``) gives each row
    the bits of the whole launch: its tiles start where that launch's do."""
    _check_shapes(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
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
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    code = _build.library().repro_sliding_window_attention_q(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.ptr(lse), B, Sq, Sk, q_offset, H, KV, D, min(window, Sk),
        chunk, _score_mult(D, softcap), float(softcap or 0.0),
        _build.stream_of(q))
    _build.check(code, "sliding_window_attention")
    sliding_window_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


sliding_window_attention_cuda.launches = 0
