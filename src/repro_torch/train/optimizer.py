"""AdamW, the cosine schedule and global-norm clipping (the port's copy of
``repro.train.optimizer``).

The state is a tree congruent with the params, as in the reference:
``AdamWState(step, mu, nu)`` with fp32 moments. The update walks the
leaves one at a time and writes params, moments and the gradient's own
storage in place: at qwen2.5-3b's 3.09e9 parameters the fp32 params,
gradients and two moments are 49.4e9 B, and a copy of any of them (a
functional update, or a foreach step over all leaves) would not fit
beside them on one 80 GB card. The arithmetic is the reference's, in
fp32; it differs from it only by the rounding of fused or reordered fp32
operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: dict                   # first moment, param-shaped, fp32
    nu: dict                   # second moment, param-shaped, fp32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_lr_ratio``
    of it at ``total_steps``; fp32 on ``step``'s device."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
        0.5 * (1 + torch.cos(_f32(math.pi, step) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def leaves(tree):
    """The leaves of a tree of dicts in the reference's leaf order (dict
    keys sorted, as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32)."""
    sq = [torch.dot(x.reshape(-1).float(), x.reshape(-1).float())
          for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(grads, max_norm: float):
    """(min(1, max_norm / norm), norm) for the global norm of ``grads``."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm): a new fp32 tree."""
    scale, norm = _clip_scale(grads, max_norm)
    return map_tree(lambda g: g.float() * scale, grads), norm


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    some = next(leaves(params))
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=some.device),
                      mu=map_tree(zeros, params), nu=map_tree(zeros, params))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads,
                 state: AdamWState) -> Tuple[dict, AdamWState, Dict]:
    """One AdamW step: clip the grads to ``grad_clip_norm`` by their global
    norm, update the moments, apply the bias-corrected step and, to
    parameters of ndim >= 2, decoupled weight decay. Updates ``params``,
    ``state.mu`` and ``state.nu`` in place and uses each gradient leaf's
    storage for its scratch (the grads are consumed; fp32 params); returns
    (params, the new state, {"grad_norm", "lr"})."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, lr), step.float())
    bc2 = 1 - torch.pow(_f32(b2, lr), step.float())
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float().mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        # delta = (m / bc1) / (sqrt(v / bc2) + eps), in g's storage
        torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)
        g.reciprocal_().mul_(m).div_(bc1)
        if p.dim() >= 2:
            g.add_(p, alpha=cfg.weight_decay)
        p.addcmul_(g, lr, value=-1)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
