"""Dense matmul with a stationary fp32 accumulator and the fused epilogue.

Counterpart of ``repro.kernels.rs_matmul`` (the row-stationary Pallas
kernel): ``(M, K) · (K, N)``, accumulated in fp32 across the whole K loop,
then bias and relu / silu / tanh-gelu in fp32 (``epilogue.fused_epilogue``)
as the accumulator is flushed. No model path calls it, as in the reference,
whose models leave dense projections to XLA; the port's entry point is
``kernels.ops.rs_matmul``.

``rs_matmul_plain`` keeps fp32 operands fp32 and widens bf16 ones, so it is
the reference's function in both dtypes; ``rs_matmul_cuda`` launches
``csrc/rs_matmul.cu`` on bf16 operands, padding M, K and N to its tile.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import act_code, fused_epilogue

TILE = 64               # output tile edge and k-step of the CUDA kernel


def _check_shapes(x, w, bias):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "multiply")
    if bias is not None and bias.numel() != w.shape[1]:
        raise ValueError(f"bias must have {w.shape[1]} entries")


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
    pm, pk, pn = (-M) % TILE, (-K) % TILE, (-N) % TILE
    xp = F.pad(x, (0, pk, 0, pm)).contiguous()
    wp = F.pad(w, (0, pn, 0, pk)).contiguous()
    bp = None
    if bias is not None:
        bp = F.pad(bias.float().reshape(-1), (0, pn)).contiguous()
    out = torch.empty((M + pm, N + pn), dtype=out_dtype, device=x.device)
    code = _build.library().repro_rs_matmul(
        xp.data_ptr(), wp.data_ptr(), _build.ptr(bp), act_code(activation),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M + pm, K + pk,
        N + pn, _build.stream_of(x))
    _build.check(code, "rs_matmul")
    rs_matmul_cuda.launches += 1
    return out[:M, :N]


rs_matmul_cuda.launches = 0
