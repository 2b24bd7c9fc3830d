"""RG-LRU recurrent block (Griffin / RecurrentGemma), the counterpart of
``repro.models.rglru``.

Prefill runs the linear recurrence h_t = a_t ⊙ h_{t-1} + b_t over the whole
prompt at once with ``layers.linear_scan`` (log-depth doubling, fp32), where
the reference uses ``jax.lax.associative_scan``; decode takes one step of it
from the carried state. Precision is the reference's: projections with bf16
operands and fp32 accumulation, the convolution's input and its state in
bf16, the gates, the scan and ``h`` in fp32. Plain PyTorch, as the reference
is plain ``jnp``: no TPU kernel lies on this block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (COMPUTE_DTYPE, causal_conv1d,
                                       dense_init, linear_scan, matmul,
                                       softplus)

_C = 8.0                 # Griffin's fixed gate exponent scale
_NUM_BLOCKS = 8          # block-diagonal gate projections
_CONV_K = 4


def init_rglru_params(cfg, generator: torch.Generator, device,
                      lead=()) -> dict:
    """Random parameters with the reference's shapes and init scales
    (``lead`` stacks them, e.g. ``(periods,)``); the values differ from
    JAX's for the same seed."""
    d, w = cfg.d_model, cfg.lru_width
    nb = _NUM_BLOCKS
    bs = w // nb

    def dense(shape, fan_in):
        return dense_init(generator, tuple(lead) + shape, fan_in, device)

    def zeros(*shape):
        return torch.zeros(tuple(lead) + shape, device=device)

    lam = torch.rand(tuple(lead) + (w,), generator=generator, device=device)
    return {
        "in_x": dense((d, w), d),
        "in_gate": dense((d, w), d),
        "conv_w": dense((_CONV_K, w), _CONV_K),
        "conv_b": zeros(w),
        "w_input_gate": dense((nb, bs, bs), bs),
        "b_input_gate": zeros(nb, bs),
        "w_rec_gate": dense((nb, bs, bs), bs),
        "b_rec_gate": zeros(nb, bs),
        # a^c = sigmoid(Lambda)^c lands in [0.9, 0.999]
        "Lambda": 2.2 + (6.9 - 2.2) * lam,
        "out_proj": dense((w, d), w),
    }


def _block_diag_proj(x, w, b):
    """x (..., nb*bs) @ block-diag w (nb, bs, bs) + b, in fp32."""
    nb, bs, _ = w.shape
    xr = x.reshape(x.shape[:-1] + (nb, bs)).float()
    y = torch.einsum("...nb,nbc->...nc", xr, w.float()) + b.float()
    return y.reshape(x.shape)


def _gates(params, x):
    """x (..., w) -> (a, gated input) in fp32."""
    i_gate = torch.sigmoid(_block_diag_proj(x, params["w_input_gate"],
                                            params["b_input_gate"]))
    r_gate = torch.sigmoid(_block_diag_proj(x, params["w_rec_gate"],
                                            params["b_rec_gate"]))
    log_a = -_C * r_gate * softplus(params["Lambda"].float())
    a = torch.exp(log_a)
    # sqrt(1 - a^2) keeps the recurrence norm-preserving
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, norm * i_gate * x.float()


def _branches(params, x):
    """The gelu gate branch (fp32) and the recurrent branch's input (bf16)."""
    gate = F.gelu(matmul(x, params["in_gate"]), approximate="tanh")
    xr = matmul(x, params["in_x"], out_dtype=COMPUTE_DTYPE)
    return gate, xr


def _out(params, h, gate):
    y = (h * gate).to(COMPUTE_DTYPE)
    return matmul(y, params["out_proj"], out_dtype=COMPUTE_DTYPE)


def rglru_block(params, x, cfg, return_state: bool = False):
    """The full block over a prompt. x (b, l, d) -> (b, l, d) bf16 [, the
    decode state after the last position]. Every position is real: padding
    would enter the carried state."""
    gate, xr = _branches(params, x)
    conv = causal_conv1d(xr, params["conv_w"], params["conv_b"])
    a, bt = _gates(params, conv)                                # (b, l, w)
    h = linear_scan(a, bt, dim=1)
    out = _out(params, h, gate)
    if not return_state:
        return out
    l, K = x.shape[1], _CONV_K
    conv_state = xr[:, l - (K - 1):] if l >= K - 1 \
        else F.pad(xr, (0, 0, K - 1 - l, 0))
    # copies: a view would keep the whole prompt's activations alive for
    # as long as the state lives
    return out, {"conv": conv_state.clone(), "h": h[:, -1].clone()}


def rglru_block_decode(params, x, state, cfg):
    """One token. x (b, 1, d); state {conv (b, K-1, w) bf16, h (b, w)
    fp32}. Returns (out (b, 1, d), new state); the caller writes the new
    state into its cache."""
    gate, xr = _branches(params, x)
    window = torch.cat([state["conv"], xr], dim=1)               # (b, K, w)
    conv = torch.einsum("bkw,kw->bw", window.float(),
                        params["conv_w"].float()) + params["conv_b"].float()
    a, bt = _gates(params, conv.to(COMPUTE_DTYPE))               # (b, w)
    h = a * state["h"] + bt
    return _out(params, h[:, None, :], gate), \
        {"conv": window[:, 1:], "h": h}


def init_rglru_state(batch: int, cfg, device=None, lead=()) -> dict:
    return {
        "conv": torch.zeros(tuple(lead) + (batch, _CONV_K - 1, cfg.lru_width),
                            dtype=COMPUTE_DTYPE, device=device),
        "h": torch.zeros(tuple(lead) + (batch, cfg.lru_width),
                         device=device),
    }
