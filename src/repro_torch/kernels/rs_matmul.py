"""Dense matmul with a stationary fp32 accumulator and the fused epilogue.

Counterpart of ``repro.kernels.rs_matmul`` (the row-stationary Pallas
kernel): ``(M, K) · (K, N)``, accumulated in fp32 across the whole K loop,
then bias and relu / silu / tanh-gelu in fp32 (``epilogue.fused_epilogue``)
as the accumulator is flushed. No model path calls it, as in the reference,
whose models leave dense projections to XLA; the port's entry point is
``kernels.ops.rs_matmul``.

``rs_matmul_plain`` keeps fp32 operands fp32 and widens bf16 ones, so it is
the reference's function in both dtypes; ``rs_matmul_cuda`` launches
``csrc/rs_matmul.cu`` on bf16 operands where they lie: its TMA maps read
ragged edges as zeros, so contiguous x and w are never copied. Above
``STREAM_M_MAX`` rows it is a TMA + ``wgmma`` GEMM on 128 x 128 tiles
(``wgmma_plan``: the last, partial round of tiles split in K); at or below,
an arm that streams w through every SM with the rows as the MMA's N. Parts
split in K are added in order by a second, small kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import act_code, fused_epilogue

STREAM_M_MAX = 16        # rows the weight-streaming arm takes (kSkMaxRows)
TILE = 128               # output tile edge of the tensor-core arm
STREAM_N, STREAM_K = 64, 256   # a unit of the streaming arm: columns x k


def _check_shapes(x, w, bias):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "multiply")
    if bias is not None and bias.numel() != w.shape[1]:
        raise ValueError(f"bias must have {w.shape[1]} entries")


def wgmma_plan(M: int, K: int, N: int, n_sm: int) -> dict:
    """The tensor-core arm's schedule (M > STREAM_M_MAX), from shapes and
    the SM count: persistent blocks (one an SM) take the 128 x 128 tiles
    round-robin; when the tiles leave a last, partial round, its
    ``split`` tiles are cut in K into ``parts`` (each block one part),
    so the busiest block no longer does a whole extra tile. Their raw
    partials are added in part order by a second kernel."""
    tiles = -(-M // TILE) * -(-N // TILE)
    grid = min(tiles, n_sm)
    split = tiles % grid if tiles > grid else 0
    parts = min(grid // split, -(-K // 64)) if split else 1
    if parts < 2:
        split, parts = 0, 1
    return {"tiles": tiles, "grid": grid, "split": split, "parts": parts}


def launch_config(M: int, K: int, N: int, n_sm: int) -> dict:
    """The arm, grid and work units ``rs_matmul_cuda`` launches."""
    if M <= STREAM_M_MAX:
        units = -(-N // STREAM_N) * -(-K // STREAM_K)
        return {"arm": "stream", "units": units, "grid": min(units, n_sm),
                "threads": 128, "stages": 4,
                "unit": f"{STREAM_N} columns x {STREAM_K} k",
                "smem_bytes": 4 * (STREAM_K * 128 + STREAM_K // 64 * 2048)
                + 1024, "k_parts": -(-K // STREAM_K)}
    plan = wgmma_plan(M, K, N, n_sm)
    return {"arm": "wgmma", "units": plan["tiles"], "grid": plan["grid"],
            "threads": 512, "stages": 4, "unit": f"{TILE} x {TILE} tile",
            "smem_bytes": 4 * 2 * TILE * 64 * 2 + TILE * (TILE + 8) * 4
            + 1024, "k_parts": 1, "split_tiles": plan["split"],
            "split_parts": plan["parts"]}


def _tma_ready(t):
    """``t`` itself when TMA can read it in place: contiguous, 16-byte
    aligned, rows a multiple of 16 bytes apart. Otherwise a copy whose
    rows are padded to 8 elements (the kernel still reads only the
    logical columns)."""
    cols = t.shape[1]
    if t.is_contiguous() and cols % 8 == 0 and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, (-cols) % 8)).contiguous()


def rs_matmul_plain(x, w, *, bias=None, activation: Optional[str] = None):
    """x (M, K) · w (K, N) in fp32, then the fused epilogue. fp32 out."""
    _check_shapes(x, w, bias)
    return fused_epilogue(x.float() @ w.float(), bias, activation)


def rs_matmul_cuda(x, w, *, bias=None, activation: Optional[str] = None,
                   out_dtype=torch.float32):
    """The same function through the CUDA kernel: x and w bf16 on the card
    (other dtypes raise), bias fp32; out fp32 or bf16."""
    _check_shapes(x, w, bias)
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be a bf16 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    M, K = x.shape
    N = w.shape[1]
    xs, ws_ = _tma_ready(x), _tma_ready(w)
    b = None if bias is None else bias.float().reshape(-1).contiguous()
    if b is not None and b.data_ptr() % 16:
        b = b.clone()                   # read in 16-byte chunks
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    part = None
    if M <= STREAM_M_MAX:
        if K > STREAM_K:                     # the K parts' planes
            part = torch.empty((-(-K // STREAM_K), M, N),
                               dtype=torch.float32, device=x.device)
    else:
        plan = wgmma_plan(M, K, N, _build.sm_count(x.device.index or 0))
        if plan["parts"] > 1:                # the split tiles' parts
            part = torch.empty((plan["split"] * plan["parts"], TILE, TILE),
                               dtype=torch.float32, device=x.device)
    code = _build.library().repro_rs_matmul(
        xs.data_ptr(), xs.shape[1], ws_.data_ptr(), ws_.shape[1],
        _build.ptr(b), act_code(activation), out.data_ptr(),
        int(out_dtype == torch.bfloat16), M, K, N, _build.ptr(part),
        _build.stream_of(x))
    _build.check(code, "rs_matmul")
    rs_matmul_cuda.launches += 1
    return out


rs_matmul_cuda.launches = 0
