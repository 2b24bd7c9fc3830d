"""HM-NoC modes mapped onto a (pod, data, model) device mesh.

The port's copy of ``repro.core.hmmesh``. The paper's four operating modes
(Fig. 8) become tensor layouts:

    BROADCAST      — replicated on every device (one copy multicast)
    UNICAST        — sharded across all axes (unique data per device)
    GROUPED_MC     — sharded over ``model``, replicated over ``data``
    INTERLEAVED_MC — sharded over ``data`` (+ ``pod``), replicated over
                     ``model``

Each data type (weights, input activations, partial sums) gets its own
mode, as the paper runs three separate NoCs. Without ``jax.sharding`` a
spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names; ``tuple()`` of the
reference's ``PartitionSpec`` gives the same tuple.
"""
from __future__ import annotations

import enum
from typing import Tuple


class Mode(enum.Enum):
    BROADCAST = "broadcast"
    UNICAST = "unicast"
    GROUPED_MC = "grouped_multicast"
    INTERLEAVED_MC = "interleaved_multicast"


# mesh axis names; ``pod`` is the inter-cluster level
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"


def mode_axes(mode: Mode, multi_pod: bool) -> Tuple:
    """The mesh axes a tensor dimension is sharded over under ``mode``."""
    dp = (POD_AXIS, DATA_AXIS) if multi_pod else (DATA_AXIS,)
    if mode == Mode.BROADCAST:
        return ()
    if mode == Mode.UNICAST:
        return dp + (MODEL_AXIS,)
    if mode == Mode.GROUPED_MC:
        return (MODEL_AXIS,)
    if mode == Mode.INTERLEAVED_MC:
        return dp
    raise ValueError(mode)


def spec_for(mode: Mode, ndim: int, shard_dim: int, multi_pod: bool) -> Tuple:
    """The spec placing ``mode``'s axes on ``shard_dim`` of an ndim tensor,
    e.g. ``spec_for(Mode.GROUPED_MC, 4, 2, False) == (None, None, "model",
    None)``."""
    axes = mode_axes(mode, multi_pod)
    entries: list = [None] * ndim
    if axes:
        entries[shard_dim] = axes if len(axes) > 1 else axes[0]
    return tuple(entries)


def divisible(dim_size: int, mode: Mode, mesh_shape: dict,
              multi_pod: bool) -> bool:
    """Whether ``dim_size`` shards evenly under ``mode`` on this mesh."""
    n = 1
    for a in mode_axes(mode, multi_pod):
        n *= mesh_shape[a]
    return dim_size % n == 0 if n > 1 else True
