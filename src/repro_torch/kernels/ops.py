"""Padding and dispatch around the port's kernels (counterpart of
``repro.kernels.ops``).

Each entry point picks its route from the ServePlan it is given, pads the
rows to the route's tile, and runs the kernel's plain version for a tensor
on the CPU or launches the CUDA kernel for a tensor on the card. There is no
fallback: a CUDA launch that fails raises. ``impl="plain"`` forces the plain
version on any device; it exists so that ``chip_smoke.py`` can hold each
kernel against its plain version on the card, and nothing on the serving
path passes it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sparsity as sp
from repro_torch.kernels import bcsc_matmul as _bcsc
from repro_torch.kernels import bcsc_mlp as _bmlp
from repro_torch.kernels import local_attention as _swa
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rs_matmul as _rs
from repro_torch.kernels.epilogue import fused_epilogue

# every CUDA kernel wrapper of the port, by name; each counts its launches
KERNELS = {
    "paged_attention": _paged.paged_attention_cuda,
    "bcsc_mlp": _bmlp.bcsc_mlp_cuda,
    "bcsc_matmul": _bcsc.bcsc_matmul_cuda,
    "bcsc_gemv": _bcsc.bcsc_gemv_cuda,
    "sliding_window_attention": _swa.sliding_window_attention_cuda,
    "rs_matmul": _rs.rs_matmul_cuda,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def set_launches(counts: Dict[str, int]) -> None:
    """Put the counters back to ``counts`` (``launch_counts()`` taken before
    a CUDA graph capture: the wrappers ran, but nothing was launched)."""
    for name, n in counts.items():
        KERNELS[name].launches = n


def add_launches(tally: Dict[str, int]) -> None:
    """Count one replay of a captured graph: its kernels were launched
    ``tally`` times by the card, without their Python wrappers running."""
    for name, n in tally.items():
        KERNELS[name].launches += n


def _use_kernel(t: torch.Tensor, impl: Optional[str]) -> bool:
    """True: launch the CUDA kernel. CPU tensors take the plain version."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"no kernel for tensors on {t.device}")


def _pad_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-x.shape[0]) % m
    return F.pad(x, (0, 0, 0, pad)) if pad else x.contiguous()


def is_packed(w) -> bool:
    """True for a BCSC-packed weight dict ({blocks, row_ids, col_ids})."""
    return isinstance(w, dict) and "blocks" in w and "col_ids" in w


def packed_nnzb(packed) -> torch.Tensor:
    """Real (unpadded) block count of a pack, int32 scalar."""
    n = packed.get("nnzb")
    if n is None:
        return torch.tensor(packed["blocks"].shape[0], dtype=torch.int32,
                            device=packed["blocks"].device)
    return n.to(torch.int32).reshape(())


def _col_ptr(packed, n_cols: int) -> torch.Tensor:
    """Segment starts of a pack: stored at pack time, else derived."""
    cp = packed.get("col_ptr")
    return cp if cp is not None else sp.col_ptr_from_ids(packed["col_ids"],
                                                         n_cols)


def bcsc_apply_packed(x, packed, *, n_out: int, plan, bias=None,
                      activation: Optional[str] = None,
                      out_dtype=torch.float32, impl: Optional[str] = None):
    """(M, K) bf16 · packed BCSC -> (M, n_out): the GEMV arm at decode M
    (bias and activation fused into the flush), the GEMM arm otherwise
    (epilogue as a post-op)."""
    M = x.shape[0]
    bm = plan.bcsc_bm(M)
    xp = _pad_rows(x, bm)
    blocks, rows = packed["blocks"], packed["row_ids"]
    kernel = _use_kernel(xp, impl)
    bn = blocks.shape[2]
    if plan.matmul_route(M) == "gemv" and bm == plan.gemv_bm:
        if kernel:
            out = _bcsc.bcsc_gemv_cuda(
                xp, blocks, rows, _col_ptr(packed, n_out // bn), n_out=n_out,
                bias=None if bias is None else bias.float().reshape(-1),
                activation=activation)
        else:
            out = _bcsc.bcsc_gemv_plain(xp, blocks, rows, packed["col_ids"],
                                        n_out=n_out, bias=bias,
                                        activation=activation)
        return out[:M].to(out_dtype)
    if kernel:
        out = _bcsc.bcsc_matmul_cuda(xp, blocks, rows,
                                     _col_ptr(packed, n_out // bn),
                                     n_out=n_out)
    else:
        out = _bcsc.bcsc_matmul_plain(xp, blocks, rows, packed["col_ids"],
                                      n_out=n_out)
    if bias is not None or activation not in (None, "none"):
        out = fused_epilogue(out, bias, activation)
    return out[:M].to(out_dtype)


def bcsc_mlp_packed(x, gate_packed, up_packed, down_packed, *, d_ff: int,
                    n_out: int, plan, activation: Optional[str] = None,
                    counts=None, out_dtype=torch.float32,
                    impl: Optional[str] = None):
    """The fused sparse MLP over packed dicts (``up_packed`` None when
    ungated). ``counts`` is the pack-time (3,) int32 [n_g, n_u, n_d]
    (``_bcsc_counts``), assembled here when absent."""
    M = x.shape[0]
    xp = _pad_rows(x, plan.bcsc_bm(M))
    gated = up_packed is not None
    if counts is None:
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        counts = torch.stack([packed_nnzb(gate_packed),
                              packed_nnzb(up_packed) if gated else zero,
                              packed_nnzb(down_packed)])
    counts = counts.to(torch.int32).reshape(3)
    if _use_kernel(xp, impl):
        def pack(p, n_cols):
            return None if p is None else (
                p["blocks"], p["row_ids"], _col_ptr(p, n_cols))
        out = _bmlp.bcsc_mlp_cuda(
            xp, pack(gate_packed, d_ff // 16), pack(up_packed, d_ff // 16),
            pack(down_packed, n_out // 16), counts.contiguous(), d_ff=d_ff,
            n_out=n_out, activation=activation)
    else:
        def pack(p):
            return None if p is None else (
                p["blocks"], p["row_ids"], p["col_ids"])
        out = _bmlp.bcsc_mlp_plain(xp, pack(gate_packed), pack(up_packed),
                                   pack(down_packed), counts, d_ff=d_ff,
                                   n_out=n_out, activation=activation)
    return out[:M].to(out_dtype)


def paged_attention(q, k_pool, v_pool, block_table, lengths, *,
                    k_scale=None, v_scale=None, softcap: float = 0.0,
                    impl: Optional[str] = None):
    """Decode attention through a block table. q (B,1,H,D) bf16; pools
    (P,ps,KV,D); block_table (B,MP) int32 (-1 = no page); lengths (B,)
    int32. Returns (B,1,H,D) fp32."""
    B, _, H, D = q.shape
    KV = k_pool.shape[2]
    qr = q.reshape(B, KV, H // KV, D).contiguous()
    kw = dict(k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    if _use_kernel(qr, impl):
        out = _paged.paged_attention_cuda(qr, k_pool, v_pool, block_table,
                                          lengths, **kw)
    else:
        out = _paged.paged_attention_plain(qr, k_pool, v_pool, block_table,
                                           lengths, **kw)
    return out.reshape(B, 1, H, D)


def sliding_window_attention(q, k, v, *, window: int, softcap: float = 0.0,
                             impl: Optional[str] = None):
    """Causal sliding-window GQA attention. q (B,S,H,D) bf16; k, v
    (B,S,KV,D) bf16. Returns (B,S,H,D) fp32; ``window >= S`` is causal."""
    if _use_kernel(q, impl):
        return _swa.sliding_window_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), window=window,
            softcap=softcap)
    return _swa.sliding_window_attention_plain(q, k, v, window=window,
                                               softcap=softcap)


def flash_attention(q, k, v, *, softcap: float = 0.0,
                    impl: Optional[str] = None):
    """Full causal attention: the sliding window with window = S."""
    return sliding_window_attention(q, k, v, window=q.shape[1],
                                    softcap=softcap, impl=impl)


def rs_matmul(x, w, *, bias=None, activation: Optional[str] = None,
              out_dtype=torch.float32, impl: Optional[str] = None):
    """Dense (M, K) · (K, N), any M, K, N, with bias (N,) and the activation
    fused into the accumulator flush. On the card x and w must be bf16."""
    if _use_kernel(x, impl):
        return _rs.rs_matmul_cuda(x, w, bias=bias, activation=activation,
                                  out_dtype=out_dtype)
    return _rs.rs_matmul_plain(x, w, bias=bias,
                               activation=activation).to(out_dtype)
