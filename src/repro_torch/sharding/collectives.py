"""Hierarchical collectives on the (pod, data, model) mesh (the port's copy
of ``repro.sharding.collectives``).

The paper's two-level NoC (all-to-all inside a cluster, mesh between
clusters) motivates the classic hierarchical all-reduce: reduce-scatter
inside the pod, all-reduce the shards across pods, all-gather inside the
pod. Inter-pod traffic drops by the intra-pod fan-in — the HM-NoC scaling
argument (§III-D).

On a logical mesh the port runs shard-explicit: every device's value sits
on a leading stacked axis of one tensor (device ``i`` at index ``i``, in
the mesh's row-major order, as ``shard_map`` stacks them), each collective
computes what every device would hold after it, and its sums run in the
reference's schedule and source-index order. On a process mesh
(``mesh.group``: one rank a dp replica, ``sharding.dist``) the same
collectives run over the ranks (``allreduce_ranks``, ``allgather_ranks``,
``mean_over_ranks``). The reference's ``shard_map`` and ``axis_size`` are
JAX version shims with no meaning here.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed
import torch.nn.functional as F

from repro_torch.sharding import dist


def hierarchical_psum(xs: torch.Tensor) -> torch.Tensor:
    """All-reduce over (pod x inner) as RS(inner) -> AR(pod) -> AG(inner).

    ``xs`` (n_pod, n_inner, ...) holds each device's value; returns the
    same shape, every device's result (all equal to the sum). Each value
    is flattened and padded with zeros to a multiple of n_inner, as the
    reference pads; the reduce-scatter sums inner index j's chunk over
    the pod's devices in index order, the all-reduce sums those over the
    pods in order, and the all-gather concatenates the chunks."""
    n_pod, n_inner = xs.shape[:2]
    shape = xs.shape[2:]
    flat = xs.reshape(n_pod, n_inner, -1)
    pad = (-flat.shape[-1]) % n_inner
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(n_pod, n_inner, n_inner, -1)  # [pod, src, chunk]
    scattered = chunks[:, 0]
    for src in range(1, n_inner):                         # psum_scatter
        scattered = scattered + chunks[:, src]
    total = scattered[0]
    for p in range(1, n_pod):                             # psum over pods
        total = total + scattered[p]
    out = total.reshape(-1)                               # all_gather
    if pad:
        out = out[:-pad]
    return out.reshape(shape).expand((n_pod, n_inner) + tuple(shape)) \
        .clone()


def allreduce_stacked(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum per-replica values stacked on dim 0 over the data-parallel axes.

    x: (n_dp, ...), replica ``i`` at index ``i`` (pod-major on a
    multi-pod mesh); returns the (replicated) sum, through the
    hierarchical schedule when the mesh has a pod axis, else summed in
    replica order."""
    if mesh.pod > 1:
        return hierarchical_psum(
            x.reshape((mesh.pod, mesh.data) + tuple(x.shape[1:])))[0, 0]
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def ring_allgather(xs: torch.Tensor) -> torch.Tensor:
    """All-gather via (n-1) ring hops. ``xs`` (n, ...) holds each device's
    value; returns (n, n, ...): device ``i``'s gathered values along a new
    leading dim ordered by source index. Each hop passes every device's
    last received value on to its successor; position ``j`` of a device's
    hops holds the value from device (i - j) % n, put back in source
    order at the end. Exact: values are moved, never summed."""
    n = xs.shape[0]
    hops = [xs]
    cur = xs
    for _ in range(n - 1):
        cur = torch.roll(cur, 1, dims=0)         # device i gets i - 1's
        hops.append(cur)
    stacked = torch.stack(hops, 1)               # [device, hop]
    idx = torch.arange(n, device=xs.device)
    src = (idx[:, None] - idx[None, :]) % n      # hop j of device i: source
    out = torch.empty_like(stacked)
    out[idx[:, None], src] = stacked
    return out


# ------------------------------------------------- over a process mesh
def allreduce_ranks(mesh, x: torch.Tensor) -> torch.Tensor:
    """``allreduce_stacked`` over the ranks of a process mesh: ``x`` (this
    rank's value) becomes, in place, the sum over the dp replicas, and is
    returned (a gradient that autograd left strided is reduced through a
    contiguous copy). With a pod axis it runs ``hierarchical_psum``'s
    schedule on the ranks' sub-groups (``Group.subgroups``): the value
    flattened and padded with zeros to a multiple of ``mesh.data``,
    reduce-scattered over the pod's ranks, the chunks all-reduced across
    the pods, then all-gathered over the pod's ranks. Else one
    all-reduce."""
    if mesh.pod == 1:
        flat = x if x.is_contiguous() else x.contiguous()   # NCCL's need
        torch.distributed.all_reduce(flat)
        return x if flat is x else x.copy_(flat)
    by_pod, by_data = mesh.group.subgroups(mesh.pod, mesh.data)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % mesh.data
    if pad:
        flat = F.pad(flat, (0, pad))
    chunk = flat.new_empty(flat.numel() // mesh.data)
    dist.scatter_sum_into(chunk, flat.contiguous(), group=by_pod)
    torch.distributed.all_reduce(chunk, group=by_data)
    out = flat.new_empty(flat.numel())
    dist.gather_into(out, chunk, group=by_pod)
    x.copy_(out[:x.numel()].view(x.shape))
    return x


def allgather_ranks(mesh, x: torch.Tensor) -> torch.Tensor:
    """``ring_allgather`` over the ranks of a process mesh: (n_dp, ...),
    every replica's ``x`` in source (rank) order, on every rank."""
    out = x.new_empty((mesh.dp,) + tuple(x.shape))
    dist.gather_into(out, x.reshape((1,) + tuple(x.shape)).contiguous())
    return out


def mean_over_ranks(mesh, values: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each scalar of ``values`` summed over the replicas in replica order
    in fp32 and divided by n_dp, the same on every rank: the one-process
    steps' mean (``grad_compression._pmean``) bit for bit."""
    every = allgather_ranks(mesh, torch.stack([v.float() for v in values]))
    total = every[0]
    for i in range(1, mesh.dp):
        total = total + every[i]
    return list((total / mesh.dp).unbind())
