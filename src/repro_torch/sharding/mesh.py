"""The training mesh: (pod, data, model) axes over the devices there are.

:class:`TrainMesh` is the port's counterpart of the reference's
``jax.sharding.Mesh`` for training. As sharded serving's
``serve.shard.ServeMesh``, it is logical unless enough devices back it:
the port runs every shard of a step in one process, on one device
(``device``), shard after shard, so a data=2, model=4 mesh trains on one
card. ``make_local_mesh`` and ``mesh_desc`` are the port's copies of the
reference's ``launch.mesh.make_local_mesh`` and ``launch.cell.mesh_desc``
(whose modules lower XLA programs and stay JAX-only); tests, examples and
``chip_smoke.py`` build a larger logical mesh directly, as the reference's
tests force eight host devices.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.planner import MeshDesc


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    data: int = 1
    model: int = 1
    pod: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if min(self.pod, self.data, self.model) < 1:
            raise ValueError(f"axis sizes must be >= 1: {self}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """("data", "model"), with "pod" first on a multi-pod mesh (the
        reference's ``make_production_mesh`` axes)."""
        return (("pod",) if self.pod > 1 else ()) + ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (((self.pod,) if self.pod > 1 else ())
                + (self.data, self.model))

    @property
    def size(self) -> int:
        """Devices in the mesh (the reference's ``mesh.devices.size``)."""
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data

    @property
    def backed(self) -> bool:
        """Whether each shard could have a device of its own."""
        have = torch.cuda.device_count() if self.device == "cuda" else 1
        return have >= self.size


def make_local_mesh(model: int = 1, device: str = "cuda") -> TrainMesh:
    """A mesh over the devices there are (one CPU, or the CUDA cards):
    data = devices // model. One H100 gives data=1, model=1."""
    n = torch.cuda.device_count() if device == "cuda" else 1
    if n < 1 or n % model:
        raise ValueError(f"{n} {device} device(s) for a model axis of "
                         f"{model}")
    return TrainMesh(data=n // model, model=model,
                     device=torch.device(device).type)


def mesh_desc(mesh: TrainMesh) -> MeshDesc:
    return MeshDesc(pod=mesh.pod, data=mesh.data, model=mesh.model)
