"""Fused bias + activation epilogue (counterpart of
``repro.kernels.epilogue.fused_epilogue``).

The plain function below and the CUDA device function ``repro::epilogue`` in
``csrc/common.cuh`` compute the same thing in fp32: the GEMV kernel applies it
at its accumulator flush, the fused MLP to its gate, and the GEMM arm of
``ops.bcsc_apply_packed`` as a post-op.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = (None, "none", "relu", "silu", "gelu")
# codes of csrc/common.cuh's Act enum
ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}


def act_code(activation: Optional[str]) -> int:
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; one of "
                         f"{ACTIVATIONS}")
    return ACT_CODES[activation]


def fused_epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None) -> torch.Tensor:
    """Bias, then none | relu | silu | tanh-gelu, all in fp32."""
    act_code(activation)
    acc = acc.float()
    if bias is not None:
        acc = acc + bias.float()
    if activation == "relu":
        return torch.clamp_min(acc, 0.0)
    if activation == "silu":
        return F.silu(acc)
    if activation == "gelu":
        return F.gelu(acc, approximate="tanh")
    return acc
