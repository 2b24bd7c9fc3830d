"""Paged decode attention: K/V read through a block table.

Counterpart of ``repro.kernels.paged_attention`` (``paged_attention_raw``,
Pallas body ``_paged_kernel``). Each row's history lives in
``ceil(len / page_size)`` fixed-size pages of a shared pool, addressed through
the row's block table (the CSC address-vector indirection of the paper, with
pages in the role of non-zero blocks). One query token per row attends to it
without the history ever being gathered into a contiguous buffer.

``paged_attention_plain`` is the function in plain PyTorch (it gathers, then
takes one masked softmax); ``paged_attention_cuda`` launches the hand-written
kernels in ``csrc/paged_attention.cu``. As in the reference, both clamp every
table entry into ``[0, P - 1]`` and read the page it names, so an entry of -1
inside a row's occupancy reads page 0; neither reads a token at or past a
row's length.

On the card the work is bound by bytes (every resident K and V page read
once, ~4·R·D flops per token), so the kernel splits each row's pages over
thread blocks (flash-decoding): ``split_plan`` picks ``pages_per_split`` and
``n_split`` from shapes alone, never from ``lengths`` (reading them on the
host would sync every decode layer), so that the grid (rows, KV heads,
splits) fills the SMs. Each split stages its pages by cp.async two tiles
deep and keeps its heads' accumulators in registers; a second small kernel
combines the splits' (m, l, acc) in a fixed order. What still holds it
back: ~10 us of fixed cost per call (two launches, dependent reads), one
block per SM at head_dim 256, and, at short rows, splits that find no
page.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
HEAD_DIMS = (16, 32, 64, 128, 256)    # the kernel's instantiations
TARGET_BLOCKS_PER_SM = 2      # split_plan fills the card at least this deep
MAX_RUN = 64                  # most pages per split (the kernel's page list)


def split_plan(B: int, KV: int, MP: int, n_sm: int) -> tuple:
    """(pages_per_split, n_split) for a call on B rows, KV heads and MP table
    columns on a card of ``n_sm`` SMs: the most pages per split (at most
    MAX_RUN) for which the grid B x KV x n_split still reaches
    TARGET_BLOCKS_PER_SM blocks per SM, or one page per split when even
    that falls short. Shapes only."""
    want = -(-TARGET_BLOCKS_PER_SM * n_sm // max(B * KV, 1))
    pages = min(max(1, MP // want), MAX_RUN)
    return pages, -(-MP // pages)


def row_work_steps(length, page_size: int):
    """Pages with real work for one row: ceil(len / page_size)."""
    return (length + page_size - 1) // page_size


def work_steps(lengths, page_size: int) -> int:
    """Pages with real work over a batch: the sum of ``row_work_steps``."""
    return sum(int(row_work_steps(int(n), page_size)) for n in lengths)


def _check_shapes(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale):
    B, KV, R, D = q.shape
    P, ps, KVp, Dp = k_pool.shape
    if (KV, D) != (KVp, Dp) or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} vs pools {tuple(k_pool.shape)}"
                         f" / {tuple(v_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} for {B} rows")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None and (tuple(k_scale.shape) != (P, KV)
                                or tuple(v_scale.shape) != (P, KV)):
        raise ValueError(f"scales must be {(P, KV)}")


def paged_attention_plain(q, k_pool, v_pool, block_table, lengths, *,
                          k_scale=None, v_scale=None, softcap: float = 0.0):
    """q (B,KV,R,D); pools (P,ps,KV,D) bf16, or int8 with (P,KV) fp32
    scales (value = q · scale / 127); block_table (B,MP) int32, entries
    clamped into [0, P - 1]; lengths (B,) int32. Returns (B,KV,R,D) fp32."""
    _check_shapes(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale)
    B, KV, R, D = q.shape
    P, ps = k_pool.shape[:2]
    MP = block_table.shape[1]
    bt = block_table.long().clamp(0, P - 1)
    kd = k_pool[bt].reshape(B, MP * ps, KV, D).float()
    vd = v_pool[bt].reshape(B, MP * ps, KV, D).float()
    if k_scale is not None:
        ks = (k_scale[bt] * (1.0 / 127.0)).repeat_interleave(ps, dim=1)
        vs = (v_scale[bt] * (1.0 / 127.0)).repeat_interleave(ps, dim=1)
        kd = kd * ks[..., None]
        vd = vd * vs[..., None]
    s = torch.einsum("bgrd,btgd->bgrt", q.float(), kd) * (1.0 / math.sqrt(D))
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    tpos = torch.arange(MP * ps, device=q.device)
    valid = tpos[None, :] < lengths.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    # masked tokens carry p = 0: zero their values too, so whatever a
    # dirty or never-written slot holds cannot reach the sum
    vd = torch.where(valid[..., None, None], vd, torch.zeros_like(vd))
    acc = torch.einsum("bgrt,btgd->bgrd", p, vd)
    return acc / torch.clamp_min(p.sum(dim=-1), 1e-30)[..., None]


def paged_attention_cuda(q, k_pool, v_pool, block_table, lengths, *,
                         k_scale=None, v_scale=None, softcap: float = 0.0):
    """The same function through the CUDA kernels (tensors on the card):
    the split kernel on grid (B, KV, n_split) of ``split_plan``, then the
    combine, both on the current stream; one launch as counted."""
    _check_shapes(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale)
    B, KV, R, D = q.shape
    P, ps = k_pool.shape[:2]
    MP = block_table.shape[1]
    quantized = k_scale is not None
    want_pool = torch.int8 if quantized else torch.bfloat16
    for name, t, dt in (("q", q, torch.bfloat16), ("k_pool", k_pool, want_pool),
                        ("v_pool", v_pool, want_pool),
                        ("block_table", block_table, torch.int32),
                        ("lengths", lengths, torch.int32)) + (
            (("k_scale", k_scale, torch.float32),
             ("v_scale", v_scale, torch.float32)) if quantized else ()):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
    if R > 16:
        raise ValueError(f"at most 16 query heads per KV head, got {R}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {D}")
    pages, n_split = split_plan(B, KV, MP,
                                 _build.sm_count(q.device.index or 0))
    out = torch.empty((B, KV, R, D), dtype=torch.float32, device=q.device)
    ws = torch.empty(B * KV * n_split * R * (D + 2), dtype=torch.float32,
                     device=q.device)
    code = _build.library().repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _build.ptr(k_scale), _build.ptr(v_scale), block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, KV, R, D, P,
        ps, MP, pages, n_split, 1.0 / math.sqrt(D), float(softcap),
        _build.stream_of(q))
    _build.check(code, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
