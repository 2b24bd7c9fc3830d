"""Training step, microbatched gradient accumulation and remat policies
(the port's copy of ``repro.train.loop``).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the reference's pure step, except that the
optimizer updates params and moments in place (``optimizer.adamw_update``)
and returns the same tensors. Gradients come from autograd through the
port's forward (``models.transformer.loss_fn``), whose attention runs the
flash backward kernel on the card. ``hints`` (``sharding.autoshard.
make_hints``, for a mesh of more than one device) run the step as the
reference runs it on that mesh, every shard in this process: attention
sequence-sharded where the head counts do not divide the model axis. On a
process mesh (``mesh.group``, ``sharding.dist``) each rank is one dp
replica: it takes its rows of the batch, and the replicas' gradients are
summed over the ranks before the update. ``abstract_train_state`` is the
state on the ``meta`` device, the port's ``jax.eval_shape``
(``checkpoint.manager`` restores into it).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.data.pipeline import replica_rows
from repro_torch.models import transformer as tfm
from repro_torch.sharding import collectives, dist
from repro_torch.train import optimizer as opt_lib


def _split_microbatches(batch: Dict, k: int):
    """k batches of B // k rows each, in row order."""
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"{name} has {x.shape[0]} rows, not a multiple "
                             f"of {k} microbatches")
    return [{name: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
             for name, x in batch.items()} for i in range(k)]


def make_loss_fn(cfg, remat_policy: str, hints=None, plan=None,
                 impl: Optional[str] = None) -> Callable:
    def loss_fn(params, batch):
        return tfm.loss_fn(params, batch, cfg, remat_policy=remat_policy,
                           hints=hints, plan=plan, impl=impl)
    return loss_fn


def _detach(metrics: Dict) -> Dict:
    return {k: v.detach() for k, v in metrics.items()}


def _layered(params):
    """``params`` with every stacked leaf (under ``blocks``: periods on the
    leading axis) replaced by the tuple of its per-layer views, which the
    model indexes as it indexes the stacked tensor
    (``transformer.layer``). Taking gradients with respect to the views
    gives each layer's own gradient, stacked once after the backward: with
    respect to the stacked tensor, every layer's slice would come back as
    a zero-filled stacked-size tensor, and autograd would sum them (at
    qwen2.5-3b, 36 sums of up to 3.2 GB per leaf, 0.5 s of the card a
    step)."""
    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items()}
        return tree.unbind(0)
    return {k: unbind(v) if k == "blocks" else v for k, v in params.items()}


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``, detached, the
    grads a tree like ``params``: each stacked leaf's per-layer gradients
    (taken with respect to ``_layered``'s views) stacked once. ``params``
    record gradients only inside the call."""
    ps = list(opt_lib.leaves(params))
    for p in ps:
        p.requires_grad_(True)
    try:
        layered = _layered(params)
        loss, metrics = loss_fn(layered, batch)
        leaves = list(opt_lib.leaves(layered))
        flat = list(torch.autograd.grad(
            loss, [t for leaf in leaves for t in _parts(leaf)],
            allow_unused=True, materialize_grads=True))
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads, i = [], 0
    for leaf in leaves:
        n = len(_parts(leaf))
        g = flat[i:i + n]
        flat[i:i + n] = [None] * n       # the layers' grads die once stacked
        grads.append(torch.stack(g) if isinstance(leaf, tuple) else g[0])
        del g
        i += n
    it = iter(grads)
    return loss.detach(), _detach(metrics), opt_lib.map_tree(
        lambda _: next(it), _sorted(params))


def _parts(leaf):
    """A ``_layered`` leaf's tensors: its layers' views, or itself."""
    return leaf if isinstance(leaf, tuple) else (leaf,)


def make_train_step(cfg, opt_cfg: opt_lib.OptimizerConfig,
                    remat_policy: str = "dots", microbatches: int = 1,
                    hints=None, plan=None, impl: Optional[str] = None,
                    mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``microbatches`` k > 1 the batch is split into k row
    blocks whose fp32 gradients are summed in order and divided by k, the
    loss and metrics averaged, as the reference's scan does. ``impl`` is
    passed on to the attention (``impl="plain"`` forces the plain versions,
    for comparisons on the card). ``hints`` are active in every forward and
    backward of the step (``models.transformer.forward``).

    On a process ``mesh`` (``mesh.group`` set) the step takes the whole
    batch and runs the forward and backward on this rank's rows
    (``data.pipeline.replica_rows``); the gradients are summed over the
    replicas (``collectives.allreduce_ranks``) and divided by n_dp, the
    loss and metrics averaged over them in replica order, and AdamW runs
    on every rank, so the params stay replicated: a per-leaf checksum
    across the ranks (``dist.check_replicated``) raises after an update
    that left them apart. A mesh without a group changes nothing."""
    loss_fn = make_loss_fn(cfg, remat_policy, hints, plan, impl)
    group = None if mesh is None else mesh.group

    def train_step(params, opt_state, batch):
        if group is not None:
            batch = replica_rows(batch, mesh.dp_index, mesh.dp)
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads, loss, seq = None, 0.0, []
            for mb in _split_microbatches(batch, microbatches):
                loss_i, m_i, g = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    grads = g
                else:
                    for acc, gi in zip(opt_lib.leaves(grads),
                                       opt_lib.leaves(g)):
                        acc.add_(gi.float())
                loss = loss + loss_i
                seq.append(m_i)
            for acc in opt_lib.leaves(grads):
                acc.div_(microbatches)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in seq]).float()
                       .mean() for k in seq[0]}
        if group is not None:
            for g in opt_lib.leaves(grads):
                collectives.allreduce_ranks(mesh, g).div_(mesh.dp)
            names = sorted(metrics)
            loss, *means = collectives.mean_over_ranks(
                mesh, [loss] + [metrics[k] for k in names])
            metrics = dict(zip(names, means))
        params, opt_state, om = opt_lib.adamw_update(opt_cfg, params, grads,
                                                     opt_state)
        if group is not None:
            dist.check_replicated(group, opt_lib.leaves(params))
        return params, opt_state, {**metrics, **om, "loss_total": loss}

    return train_step


def _sorted(tree):
    """``tree`` with its dict keys in sorted order (the leaf order of
    ``optimizer.leaves``), so that a tree rebuilt from that order by
    ``map_tree`` puts each leaf back in its place."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def make_eval_step(cfg, plan=None, impl: Optional[str] = None) -> Callable:
    """eval_step(params, batch) -> metrics with ``loss_total``, no
    gradients, no remat."""
    loss_fn = make_loss_fn(cfg, "none", plan=plan, impl=impl)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {**metrics, "loss_total": loss}

    return eval_step


def init_train_state(cfg, generator: torch.Generator, device=None
                     ) -> Tuple[dict, opt_lib.AdamWState]:
    """Seeded fp32 params (``transformer.init_params``) and zero AdamW
    moments, on ``device`` (the generator's by default)."""
    params = tfm.init_params(cfg, generator, device)
    return params, opt_lib.init_adamw(params)


def abstract_train_state(cfg) -> Tuple[dict, opt_lib.AdamWState]:
    """(params, AdamW state) as ``meta`` tensors of their shapes and
    dtypes: a restore target that holds no memory."""
    params = tfm.abstract_params(cfg)
    return params, opt_lib.init_adamw(params)
