"""Data-reuse analysis (paper §I-A, Table I, Fig. 2); the port's copy of
``repro.core.reuse``.

A DNN layer is described by the paper's dimensions
    G (groups) N (batch) M (out ch) C (in ch) H/W (ifmap) R/S (filter) E/F (ofmap)
and *data reuse* = MACs that touch the same value, per data type:

    weight reuse = N·E·F            (every output pixel in the batch)
    iact  reuse  = M·R·S / U²       (every out channel, every overlapping window)
    psum  reuse  = C·R·S            (accumulation depth)

Transformer matmuls are the degenerate case the paper warns about: R=S=E=F=1 —
reuse collapses onto N (weights), M (iacts) and C (psums) alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Paper Table-I dimensions. For GEMMs: N=tokens, C=in, M=out, rest 1."""
    name: str
    N: int = 1
    M: int = 1
    C: int = 1
    G: int = 1
    H: int = 1
    W: int = 1
    R: int = 1
    S: int = 1
    E: int = 1
    F: int = 1
    U: int = 1  # stride
    sparsity_w: float = 0.0   # fraction of zero weights
    sparsity_a: float = 0.0   # fraction of zero iacts

    @property
    def macs(self) -> int:
        return self.G * self.N * self.M * self.C * self.E * self.F * self.R \
            * self.S

    @property
    def effective_macs(self) -> int:
        """MACs after zero-skipping both operands (paper §IV)."""
        return int(self.macs * (1 - self.sparsity_w) * (1 - self.sparsity_a))

    @property
    def weight_count(self) -> int:
        return self.G * self.M * self.C * self.R * self.S

    @property
    def iact_count(self) -> int:
        return self.G * self.N * self.C * self.H * self.W

    @property
    def psum_count(self) -> int:
        return self.G * self.N * self.M * self.E * self.F


def reuse(shape: LayerShape) -> Dict[str, float]:
    """MACs per value, for each of the paper's three data types."""
    return {
        "weight": shape.macs / max(shape.weight_count, 1),
        "iact": shape.macs / max(shape.iact_count, 1),
        "psum": shape.macs / max(shape.psum_count, 1),
    }


def gemm(name: str, tokens: int, c_in: int, m_out: int, groups: int = 1,
         sparsity_w: float = 0.0, sparsity_a: float = 0.0) -> LayerShape:
    """A transformer matmul as a LayerShape."""
    return LayerShape(name=name, N=tokens, C=c_in, M=m_out, G=groups,
                      sparsity_w=sparsity_w, sparsity_a=sparsity_a)


def conv(name: str, n: int, c: int, m: int, h: int, w: int, r: int, s: int,
         u: int = 1, groups: int = 1) -> LayerShape:
    e = (h - r) // u + 1
    f = (w - s) // u + 1
    return LayerShape(name=name, N=n, C=c, M=m, G=groups, H=h, W=w, R=r, S=s,
                      E=e, F=f, U=u)


# ----------------------------------------------------------- model → workload
def model_gemms(cfg, tokens: int, decode: bool = False):
    """Decompose an ArchConfig into its per-layer GEMM workloads (one pattern
    period + head/embed). ``tokens`` = batch·seq per step."""
    out = []
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    for j, kind in enumerate(cfg.attn_pattern):
        if kind in ("global", "local", "chunked"):
            out.append(gemm(f"l{j}.attn.q", tokens, d, H * hd))
            out.append(gemm(f"l{j}.attn.kv", tokens, d, 2 * KV * hd))
            out.append(gemm(f"l{j}.attn.o", tokens, H * hd, d))
            # score/context GEMMs: reduction over context length
            ctx = cfg.window_size if kind == "local" else (
                cfg.chunk_size if kind == "chunked" else tokens)
            out.append(gemm(f"l{j}.attn.qk", tokens, hd, min(ctx, tokens),
                            groups=H))
        elif kind == "ssm":
            di = cfg.d_inner
            out.append(gemm(f"l{j}.ssm.in", tokens, d,
                            2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state +
                            cfg.ssm_nheads))
            out.append(gemm(f"l{j}.ssm.out", tokens, di, d))
        elif kind == "rglru":
            w = cfg.lru_width
            out.append(gemm(f"l{j}.rglru.in", tokens, d, 2 * w))
            out.append(gemm(f"l{j}.rglru.out", tokens, w, d))
        if kind == "ssm":           # a Mamba-2 block has no MLP after it
            continue
        if cfg.is_moe_layer(j):
            # routed experts: the G dimension of Table I
            per_e = tokens * cfg.experts_per_token // cfg.num_experts
            out.append(gemm(f"l{j}.moe.up", max(per_e, 1), d, 2 * cfg.d_ff,
                            groups=cfg.num_experts))
            out.append(gemm(f"l{j}.moe.down", max(per_e, 1), cfg.d_ff, d,
                            groups=cfg.num_experts))
        else:
            ff = cfg.dense_d_ff or cfg.d_ff
            nup = 2 if cfg.mlp_gated else 1
            out.append(gemm(f"l{j}.mlp.up", tokens, d, nup * ff))
            out.append(gemm(f"l{j}.mlp.down", tokens, ff, d))
    out.append(gemm("lm_head", tokens, d, cfg.vocab_padded))
    return out
