"""Named meshes over a ``torch.distributed`` process group (the port of
``repro/launch/mesh.py``).

Single pod: (data, model) = (16, 16), 256 ranks.  Multi-pod: (pod, data,
model) = (2, 16, 16), 512 ranks, the ``pod`` axis crossing hosts.  Ranks
sit on the mesh in row-major order of its axes (the last axis fastest), as
``jax.make_mesh`` places CPU devices: on a (2, 2) mesh ranks 0 and 1 share
data coordinate 0.

``AbstractMesh`` carries only the axes and their sizes (the counterpart of
``jax.sharding.AbstractMesh``): the sharding rules of
``distributed.sharding`` work on it without a single rank.  ``Mesh`` adds
the process group, this rank's coordinates and one ``torch.distributed``
subgroup for each proper subset of its axes (each axis, the data-parallel
axes together, any pair of a three-axis mesh).  Every
subgroup is made with ``dist.new_group`` on every rank in one order, the
groups a rank is not in included, as ``new_group`` requires; so every rank
of the default group builds the mesh, even where ``group`` is a part of it.

The port keeps this class rather than ``torch.distributed.device_mesh.
DeviceMesh``: a ``"cuda"`` DeviceMesh binds its subgroups to NCCL, which
refuses several ranks on one card, and gloo moves host tensors only; the
port's collectives (``distributed.comm``) stage CUDA tensors through pinned
host memory on gloo subgroups made here.
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

__all__ = ["AbstractMesh", "Mesh", "make_production_mesh", "make_local_mesh",
           "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """Axis names and sizes only; ``shape`` maps each axis to its size."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} "
                             f"axes")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s) for a, s in
                                      zip(axis_names, axis_sizes)}

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A mesh over the ranks of ``group`` (default: the default group),
    which must hold ``prod(axis_sizes)`` ranks.  ``coords`` maps each axis
    to this rank's coordinate; ``group_of(*axes)`` is the subgroup of the
    ranks that share this rank's coordinates on every other axis."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 group=None):
        import torch.distributed as dist

        super().__init__(axis_sizes, axis_names)
        self.group = dist.group.WORLD if group is None else group
        ranks = dist.get_process_group_ranks(self.group)
        if len(ranks) != self.size:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} "
                             f"ranks, the group has {len(ranks)}")
        sizes = [self.shape[a] for a in self.axis_names]
        grid = list(itertools.product(*[range(s) for s in sizes]))
        me = dist.get_rank()
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, grid[ranks.index(me)] if me in ranks
            else (None,) * len(sizes)))
        self._groups: Dict[Tuple[str, ...], object] = {}
        # every proper subset of the axes, in the mesh's order: the data
        # axes together, and any set a leaf's spec shards a block on
        wanted = [axes for n in range(1, len(self.axis_names))
                  for axes in itertools.combinations(self.axis_names, n)]
        for axes in wanted:
            pos = [self.axis_names.index(a) for a in axes]
            others = [i for i in range(len(sizes)) if i not in pos]
            # one subgroup per coordinate of the other axes, in one order
            for fixed in itertools.product(*[range(sizes[i]) for i in others]):
                members = [ranks[j] for j, c in enumerate(grid)
                           if all(c[i] == f for i, f in zip(others, fixed))]
                g = dist.new_group(members)
                if me in members:
                    self._groups[axes] = g

    def group_of(self, *axes: str):
        """The subgroup over ``axes`` (any of the mesh's axes, in any
        order) holding this rank."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == len(self.axis_names):
            return self.group
        return self._groups[axes]


def make_production_mesh(multi_pod: bool = False, group=None):
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model").  Without a group of 256 or 512 ranks
    (``group`` None and no default group of that size) it is the abstract
    form; it is never a smaller mesh."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    if group is None:
        import torch.distributed as dist

        mesh = AbstractMesh(shape, names)
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == mesh.size):
            return mesh
    return Mesh(shape, names, group)


def make_local_mesh(n_data: int = 1, n_model: int = 1, group=None) -> Mesh:
    """A (data, model) mesh over ``group`` (default: the default group),
    which holds ``n_data * n_model`` ranks."""
    return Mesh((n_data, n_model), ("data", "model"), group)

