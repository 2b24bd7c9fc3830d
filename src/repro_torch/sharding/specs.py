"""Named-axis helpers and divisibility-aware partition specs (the port's
copy of ``repro.sharding.specs``).

:class:`P` is the port's PartitionSpec: a tuple with one entry per leading
dimension of a tensor, each ``None`` (replicated), a mesh axis name or a
tuple of names (the dimension split over their product, the first axis
outermost). Trailing dimensions without an entry are replicated.
:func:`named` pairs a spec with a mesh as a :class:`Layout`, the per-shard
view of a tensor: the port runs every shard in one process, so a layout
says how a tensor *would* be cut, and never places it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh_axes: Dict[str, int]) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh, ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def axes_size(mesh_axes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_axes[axes]
    n = 1
    for a in axes:
        n *= mesh_axes[a]
    return n


def maybe(axes, dim_size: int, mesh_axes: Dict[str, int]):
    """Return ``axes`` if ``dim_size`` divides evenly over them, else None.

    This is the planner's fall-back-to-BROADCAST rule for diminished
    dimensions (e.g. GQA kv_heads < model axis — paper Table I)."""
    if axes is None:
        return None
    n = axes_size(mesh_axes, axes)
    if n <= 1 or dim_size % n != 0:
        return None
    if isinstance(axes, (list, tuple)) and len(axes) == 1:
        return axes[0]
    return tuple(axes) if isinstance(axes, (list, tuple)) else axes


@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec over a mesh (the reference's ``NamedSharding``): how each
    dimension of a tensor is cut over the mesh's axes."""
    mesh: object          # sharding.mesh.TrainMesh
    spec: P

    def parts(self, shape) -> Tuple[int, ...]:
        """The number of shards along each dimension of ``shape``."""
        sizes = mesh_axis_sizes(self.mesh)
        return tuple(axes_size(sizes, entry_axes(self.spec[i]))
                     if i < len(self.spec) else 1 for i in range(len(shape)))

    def check(self, shape) -> None:
        """Raise ``ValueError`` unless the spec fits ``shape``: no more
        entries than dimensions, known axes, each axis at most once, and
        every cut dimension a multiple of its shards."""
        sizes = mesh_axis_sizes(self.mesh)
        axes = [a for e in self.spec for a in entry_axes(e)]
        if len(self.spec) > len(shape) or len(set(axes)) < len(axes) \
                or any(a not in sizes for a in axes):
            raise ValueError(f"spec {self.spec} does not fit shape "
                             f"{tuple(shape)} on axes {sizes}")
        for dim, n in zip(shape, self.parts(shape)):
            if dim % n:
                raise ValueError(f"spec {self.spec}: dimension {dim} of "
                                 f"{tuple(shape)} does not divide into {n}")

    def local_shape(self, shape) -> Tuple[int, ...]:
        self.check(shape)
        return tuple(d // n for d, n in zip(shape, self.parts(shape)))

    def shard(self, x, coords: Dict[str, int]):
        """The slice of ``x`` that the device at ``coords`` (axis name ->
        index; axes not named are 0) holds: a view."""
        shape = tuple(x.shape)
        self.check(shape)
        sizes = mesh_axis_sizes(self.mesh)
        out = x
        for i, n in enumerate(self.parts(shape)):
            if n == 1:
                continue
            idx = 0
            for a in entry_axes(self.spec[i]):      # outermost first
                idx = idx * sizes[a] + coords.get(a, 0)
            step = shape[i] // n
            out = out.narrow(i, idx * step, step)
        return out

    def coords(self):
        """Every device's coordinates, in the mesh's row-major order."""
        names = self.mesh.axis_names
        return [dict(zip(names, c))
                for c in itertools.product(*(range(n)
                                             for n in self.mesh.shape))]


def named(mesh, spec: P) -> Layout:
    return Layout(mesh, spec)


def tree_named(mesh, spec_tree):
    """The tree of :class:`Layout` for a tree of specs (dicts, NamedTuples
    and tuples or lists of specs)."""
    if isinstance(spec_tree, P):
        return Layout(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: tree_named(mesh, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(tree_named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (tuple, list)):
        return type(spec_tree)(tree_named(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")
