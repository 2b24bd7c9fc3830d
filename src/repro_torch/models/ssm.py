"""Mamba-2 SSD (state-space duality) block: the chunked matmul form for
prefill and the one-token recurrence for decode, the counterpart of
``repro.models.ssm``.

The chunk rule and the casts are the reference's: ``c = min(chunk, l)``,
halved while it does not divide ``l`` (a prime prompt length runs ``l``
chunks of 1); the intra-chunk matrix ``M``, the inputs, ``B``, ``C`` and the
carried chunk states enter their products rounded to bf16, and every product
accumulates in fp32. The inter-chunk recurrence, a ``lax.scan`` in the
reference, is ``layers.linear_scan`` here (log-depth, fp32). Plain PyTorch,
as the reference is plain ``jnp``: no TPU kernel lies on this block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (COMPUTE_DTYPE, causal_conv1d,
                                       dense_init, linear_scan, matmul,
                                       rms_norm, softplus)


def _bf16(x):
    """x rounded to bf16 and held in fp32: a bf16 operand of an fp32
    product (the reference's ``preferred_element_type=f32`` on bf16)."""
    return x.to(COMPUTE_DTYPE).float()


def _silu(x):
    """``jax.nn.silu`` as XLA lowers it: x * (1 / (1 + exp(-x))), every
    operation in x's dtype (each rounded to bf16 on a bf16 x)."""
    return x * (1 / (1 + torch.exp(-x)))


def _segsum(a):
    """a (..., T) -> (..., T, T): out[i, j] = sum over k in (j, i] of a[k],
    -inf above the diagonal."""
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    T = a.shape[-1]
    i = torch.arange(T, device=a.device)
    return seg.masked_fill(~(i[:, None] >= i[None, :]), float("-inf"))


def _rep_groups(x, h: int):
    """(..., g, n) -> (..., h, n), each group repeated h // g times."""
    return torch.repeat_interleave(x, h // x.shape[-2], dim=-2)


def chunk_size(length: int, chunk: int) -> int:
    """The chunk a prompt of ``length`` runs: ``min(chunk, length)``,
    halved while it does not divide ``length`` (a prime length: 1)."""
    c = min(chunk, length)
    while length % c:
        c //= 2
    return c


def ssd_chunked(x, dt, A_log, B, C, chunk: int):
    """Chunked SSD scan from a zero state.

    x (b, l, h, p) bf16; dt (b, l, h) fp32, already through softplus;
    A_log (h,), A = -exp(A_log); B, C (b, l, g, n) bf16.
    Returns y (b, l, h, p) bf16 and the final state (b, h, n, p) fp32."""
    b, l, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    c = chunk_size(l, chunk)
    nc = l // c
    A = -torch.exp(A_log.float())
    dtr = dt.float().reshape(b, nc, c, h)
    xr = _bf16(x.reshape(b, nc, c, h, p))
    Br = _bf16(_rep_groups(B.reshape(b, nc, c, g, n), h))      # (b,nc,c,h,n)
    Cr = _bf16(_rep_groups(C.reshape(b, nc, c, g, n), h))

    a_t = (dtr * A).permute(0, 1, 3, 2)                         # (b,nc,h,c)
    a_cum = torch.cumsum(a_t, dim=-1)
    L = torch.exp(_segsum(a_t))                                 # (b,nc,h,c,c)

    # intra-chunk (block-diagonal) term, each j weighted by dt_j
    CB = torch.einsum("bzihn,bzjhn->bzhij", Cr, Br)
    M = CB * L * dtr.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", _bf16(M), xr)

    # chunk states: S_z = sum_j exp(a_cum[z, -1] - a_cum[z, j]) dt_j B_j x_j^T
    decay = torch.exp(a_cum[..., -1:] - a_cum)                  # (b,nc,h,c)
    w = (decay * dtr.permute(0, 1, 3, 2)).permute(0, 1, 3, 2)  # (b,nc,c,h)
    states = torch.einsum("bzch,bzchn,bzchp->bzhnp", _bf16(w), Br, xr)

    # inter-chunk recurrence: S_z = exp(a_tot_z) S_{z-1} + states_z
    a_tot = torch.exp(a_cum[..., -1])[..., None, None]         # (b,nc,h,1,1)
    after = linear_scan(a_tot, states, dim=1)                  # (b,nc,h,n,p)
    prev = torch.cat([torch.zeros_like(after[:, :1]), after[:, :-1]], dim=1)

    # the carried state's contribution: exp(a_cum[i]) C_i · S_prev
    y_off = torch.einsum("bzchn,bzhnp,bzhc->bzchp", Cr, _bf16(prev),
                         _bf16(torch.exp(a_cum)))
    y = (y_diag + y_off).reshape(b, l, h, p)
    # a copy: a view would keep every chunk's state alive with it
    return y.to(COMPUTE_DTYPE), after[:, -1].clone()


def ssd_decode_step(state, x, dt, A_log, B, C):
    """One token. state (b, h, n, p) fp32; x (b, h, p); dt (b, h);
    B, C (b, g, n). Returns y (b, h, p) bf16 and the new state."""
    h = x.shape[1]
    A = -torch.exp(A_log.float())
    da = torch.exp(dt.float() * A)                              # (b, h)
    Bh = _rep_groups(B, h).float()
    Ch = _rep_groups(C, h).float()
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt.float(), Bh, x.float())
    state = state * da[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y.to(COMPUTE_DTYPE), state


# --------------------------------------------------------------------- block
def init_ssm_params(cfg, generator: torch.Generator, device, lead=()) -> dict:
    """Random parameters with the reference's shapes and init scales
    (``lead`` stacks them); the values differ from JAX's for the same
    seed."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, hs = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    K = cfg.ssm_conv_kernel
    conv_ch = di + 2 * g * n

    def dense(shape, fan_in):
        return dense_init(generator, tuple(lead) + shape, fan_in, device)

    def full(value, *shape):
        return torch.full(tuple(lead) + shape, value, device=device)

    return {
        "in_proj": dense((d, 2 * di + 2 * g * n + hs), d),
        "conv_w": dense((K, conv_ch), K),
        "conv_b": full(0.0, conv_ch),
        "A_log": full(0.0, hs),
        "D": full(1.0, hs),
        "dt_bias": full(0.0, hs),
        "gate_norm": full(0.0, di),
        "out_proj": dense((di, d), di),
    }


def _split(cfg, zxbcdt):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(zxbcdt, [di, di, gn, gn, cfg.ssm_nheads], dim=-1)


def _gated_out(params, y, z, cfg):
    """rms_norm(y * silu(z)) through the output projection, bf16."""
    y = rms_norm((y.float() * _silu(z.float())).to(COMPUTE_DTYPE),
                 params["gate_norm"], cfg.norm_eps)
    return matmul(y, params["out_proj"], out_dtype=COMPUTE_DTYPE)


def ssm_block(params, x, cfg, return_state: bool = False):
    """The full Mamba-2 mixer over a prompt. x (b, l, d) -> (b, l, d) bf16
    [, the decode state after the last position]. Every position is real:
    padding would enter the carried state."""
    b, l, _ = x.shape
    di, g, n, hs = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    p, K = cfg.ssm_headdim, cfg.ssm_conv_kernel
    z, xin, B, C, dt = _split(cfg, matmul(x, params["in_proj"],
                                          out_dtype=COMPUTE_DTYPE))
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out = _silu(causal_conv1d(conv_in, params["conv_w"],
                                         params["conv_b"]))
    xin, B, C = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"].float())
    xh = xin.reshape(b, l, hs, p)
    y, final_state = ssd_chunked(xh, dt, params["A_log"],
                                 B.reshape(b, l, g, n), C.reshape(b, l, g, n),
                                 cfg.ssm_chunk)
    y = y.float() + params["D"].float()[None, None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(b, l, di).to(COMPUTE_DTYPE), z, cfg)
    if not return_state:
        return out
    conv_state = conv_in[:, l - (K - 1):] if l >= K - 1 \
        else F.pad(conv_in, (0, 0, K - 1 - l, 0))
    return out, {"conv": conv_state.clone(), "ssd": final_state}


def ssm_block_decode(params, x, state, cfg):
    """One token. x (b, 1, d); state {conv (b, K-1, ch) bf16, ssd (b, h,
    n, p) fp32}. Returns (out (b, 1, d), new state); the caller writes the
    new state into its cache."""
    b = x.shape[0]
    di, g, n, hs = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    p = cfg.ssm_headdim
    z, xin, B, C, dt = _split(cfg, matmul(x, params["in_proj"],
                                          out_dtype=COMPUTE_DTYPE))
    conv_in = torch.cat([xin, B, C], dim=-1)                    # (b, 1, ch)
    window = torch.cat([state["conv"], conv_in], dim=1)         # (b, K, ch)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float())
    conv_out = _silu(conv_out + params["conv_b"].float()).to(COMPUTE_DTYPE)
    xin, B, C = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    dt = softplus(dt[:, 0].float() + params["dt_bias"].float())
    xh = xin.reshape(b, hs, p)
    y, ssd_state = ssd_decode_step(state["ssd"], xh, dt, params["A_log"],
                                   B.reshape(b, g, n), C.reshape(b, g, n))
    y = y.float() + params["D"].float()[None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(b, 1, di).to(COMPUTE_DTYPE), z, cfg)
    return out, {"conv": window[:, 1:], "ssd": ssd_state}


def init_ssm_state(batch: int, cfg, device=None, lead=()) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros(tuple(lead) + (batch, cfg.ssm_conv_kernel - 1,
                                           conv_ch),
                            dtype=COMPUTE_DTYPE, device=device),
        "ssd": torch.zeros(tuple(lead) + (batch, cfg.ssm_nheads,
                                          cfg.ssm_state, cfg.ssm_headdim),
                           device=device),
    }
