"""Int8 error-feedback gradient compression for the DP all-reduce (the
port's copy of ``repro.train.grad_compression``).

Each replica quantizes its local gradient to int8 (per-tensor scale), keeps
the quantization residual in an error-feedback buffer (added back next
step — keeps Adam convergent), all-gathers the int8 payloads over the dp
axes, and dequantizes + sums in fp32 locally.

Communication: (n−1)/n · 1 byte/elt vs 2·(n−1)/n · 4 bytes for a ring fp32
all-reduce → ~8× fewer collective bytes on the DP axes.

State layout: error-feedback buffers are *per-replica*, stacked on a
leading dp axis (n_dp, *param_shape), as in the reference. On a logical
mesh the port runs the replicas shard-explicit in one process: each takes
its rows of the batch through autograd in replica order and quantizes with
its own slot, the payloads are "gathered" in the reference's order, and
every replica's sum is the same ``einsum("nd,n->d")``, so it is computed
once. On a process mesh (``mesh.group``: one rank a replica,
``sharding.dist``) each rank keeps only its own slot, (1, *param_shape),
and its own fp32 gradient; it all-gathers the int8 payloads and fp32
scales over the ranks and sums them with the same ``_combine`` in the same
``gather_order``, so every rank computes the one-process step's sum bit
for bit. Params and the optimizer state stay whole (the planner's
BROADCAST weight mode — pure DP) and are updated in place.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.data.pipeline import replica_rows
from repro_torch.sharding import collectives, dist
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib


def quantize(g, ef):
    """g fp32 + error feedback -> (q int8, scale fp32 scalar, new_ef).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gc = g.float() + ef
    scale = gc.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    new_ef = gc - q.float() * scale
    return q, scale, new_ef


def dequantize(q, scale):
    return q.float() * scale


def init_error_feedback(mesh, params):
    """Zero fp32 residuals, (n_dp, ...) per param leaf; (1, ...), this
    rank's slot alone, on a process mesh."""
    n = 1 if mesh.group is not None else mesh.dp
    return opt_lib.map_tree(
        lambda p: torch.zeros((n,) + tuple(p.shape),
                              dtype=torch.float32, device=p.device), params)


def gather_order(mesh) -> List[int]:
    """The replicas (numbered pod-major, as the mesh orders its devices) in
    the order the reference's all-gather stacks their payloads: it
    gathers over "pod", then over "data", so data is the outer index."""
    return [p * mesh.data + d for d in range(mesh.data)
            for p in range(mesh.pod)]


def _combine(qs: List[torch.Tensor], scales: List[torch.Tensor], order):
    """The gathered payloads' fp32 sum, the reference's
    ``einsum("nd,n->d")`` as XLA computes it: one fused multiply-add a
    replica (``addcmul``), in the gather's ``order``."""
    total = torch.zeros(qs[0].shape, dtype=torch.float32,
                        device=qs[0].device)
    for i in order:
        total.addcmul_(qs[i].float(), scales[i])
    return total


def compressed_allreduce_leaf(gs, efs, mesh=None):
    """gs (n_dp, ...): each replica's gradient; efs (n_dp, ...): each one's
    residual, replicas pod-major on ``mesh`` (one data axis when None).
    Returns (the summed gradient fp32, every replica's the same; the new
    residuals (n_dp, ...))."""
    qs, scales, new = [], [], []
    for g, e in zip(gs, efs):
        q, s, ne = quantize(g, e)
        qs.append(q)
        scales.append(s)
        new.append(ne)
    order = gather_order(mesh) if mesh is not None else range(len(qs))
    return _combine(qs, scales, order), torch.stack(new)


def payload_bytes(params, n_dp: int) -> int:
    """Bytes the replicas gather a step: an int8 payload and an fp32 scale
    per leaf from each of the n_dp replicas."""
    return n_dp * sum(p.numel() + 4 for p in opt_lib.leaves(params))


def make_compressed_dp_train_step(mesh, loss_fn, opt_cfg):
    """Pure-DP train step with the int8-EF gradient all-reduce.

    loss_fn(params, batch) -> (scalar, metrics). Returns
    ``step(params, opt_state, batch, ef) -> (params, opt_state, ef,
    metrics)``: replica i takes rows [i B / n_dp, (i + 1) B / n_dp) of the
    batch (the reference's ``P(dp)`` on dim 0), its gradient goes through
    ``quantize`` with its slot ``ef[..][i]`` (updated in place), the step
    divides the payloads' sum by n_dp, takes the mean (``pmean``) of the
    loss and metrics over the replicas, then runs AdamW in place. One
    replica's fp32 gradients are alive at a time beside the int8
    payloads. On a process mesh the step is ``_process_step``'s."""
    if mesh.group is not None:
        return _process_step(mesh, loss_fn, opt_cfg)
    n_dp, order = mesh.dp, gather_order(mesh)

    def step(params, opt_state, batch, ef):
        efs = list(opt_lib.leaves(ef))
        qs: List[list] = [[] for _ in efs]
        scales: List[list] = [[] for _ in efs]
        losses, seq = [], []
        for r in range(n_dp):
            loss, metrics, grads = train_loop.value_and_grad(
                loss_fn, params, replica_rows(batch, r, n_dp))
            for i, g in enumerate(opt_lib.leaves(grads)):
                q, s, new_ef = quantize(g, efs[i][r])
                efs[i][r].copy_(new_ef)
                qs[i].append(q)
                scales[i].append(s)
                del new_ef
            del grads
            losses.append(loss)
            seq.append(metrics)
        it = iter(range(len(efs)))

        def summed(_):
            i = next(it)
            total = _combine(qs[i], scales[i], order).div_(n_dp)
            qs[i] = scales[i] = None
            return total
        grads = opt_lib.map_tree(summed, train_loop._sorted(params))
        loss = _pmean(losses, n_dp)
        metrics = {k: _pmean([mt[k] for mt in seq], n_dp) for k in seq[0]}
        params, opt_state, om = opt_lib.adamw_update(opt_cfg, params, grads,
                                                     opt_state)
        return params, opt_state, ef, {**metrics, **om, "loss_total": loss}

    return step


def _process_step(mesh, loss_fn, opt_cfg):
    """The compressed step of one rank of a process mesh: the same
    signature and result as the one-process step's. This rank's rows go
    through autograd, each gradient leaf through ``quantize`` with the
    rank's slot ``ef[..][0]`` (updated in place); the payloads and scales
    are all-gathered over the ranks leaf by leaf and summed by ``_combine``
    in ``gather_order``, then divided by n_dp; the loss and metrics are
    the replicas' mean in replica order (``collectives.mean_over_ranks``).
    AdamW then runs on every rank and ``dist.check_replicated`` holds the
    params equal across the ranks."""
    n_dp, order, group = mesh.dp, gather_order(mesh), mesh.group

    def step(params, opt_state, batch, ef):
        loss, metrics, grads = train_loop.value_and_grad(
            loss_fn, params, replica_rows(batch, mesh.dp_index, n_dp))
        gs = list(opt_lib.leaves(grads))
        del grads
        efs = iter(list(opt_lib.leaves(ef)))
        it = iter(range(len(gs)))

        def summed(_):
            i, e = next(it), next(efs)
            q, s, new_ef = quantize(gs[i], e[0])
            e[0].copy_(new_ef)
            gs[i] = new_ef = None          # only this rank's gradient lives
            qs = collectives.allgather_ranks(mesh, q)
            scales = collectives.allgather_ranks(mesh, s)
            return _combine(list(qs), list(scales), order).div_(n_dp)
        grads = opt_lib.map_tree(summed, train_loop._sorted(params))
        names = sorted(metrics)
        loss, *means = collectives.mean_over_ranks(
            mesh, [loss] + [metrics[k] for k in names])
        params, opt_state, om = opt_lib.adamw_update(opt_cfg, params, grads,
                                                     opt_state)
        dist.check_replicated(group, opt_lib.leaves(params))
        return params, opt_state, ef, {**dict(zip(names, means)), **om,
                                       "loss_total": loss}

    return step


def _pmean(values, n: int):
    """The replicas' values summed in replica order, over n."""
    total = values[0].float()
    for v in values[1:]:
        total = total + v.float()
    return total / n

