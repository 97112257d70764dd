"""The port's device mesh: named axes over ``torch.distributed`` ranks.

A ``Mesh`` describes one rank of a job: the axis sizes (``{"data": D,
"model": M}``), this rank's index, its device and the process group its
collectives run on. ``with mesh:`` makes it the active mesh, as the JAX
package's ``with mesh:`` does: the model code reads it
(``active_mesh()``) to take its rank's heads, columns and vocabulary rows
and to complete the partial sums (``runtime/collectives.py``). The
ranks are laid out row-major over the axes, the last axis fastest, and a
mesh of ``size`` ranks takes the process world's ranks ``[0, size)``: a
rank at or past ``size`` (after a re-mesh onto fewer ranks) is outside it
(``member`` False).

Three process groups serve a rank: ``group``, its replica's ``model``
group (the ranks that share its data coordinate: the tensor-parallel
collectives); ``data_group``, the ranks that share its model coordinate
(the per-step exchange of sampled tokens across replicas); and
``mesh_group``, every rank of the mesh (a live re-mesh gathers the slot
state over it). They are taken from ``groups``, the groups of every mesh
shape the process world holds, which ``launch/mesh.py`` creates once, so
a re-mesh creates none.

``abstract_mesh`` gives a mesh without processes, for the sharding rules
alone; ``launch/mesh.py`` builds a rank's mesh over a process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

_ACTIVE: list = []              # the ``with mesh:`` stack
DATA_AXES = ("pod", "data")     # the replica axes, outermost first


def active_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered with ``with mesh:`` (None outside)."""
    return _ACTIVE[-1] if _ACTIVE else None


@dataclass
class Mesh:
    """One rank's view of a (data, model) mesh. ``shape`` maps each axis
    name to its size, in axis order; ``rank`` is the rank in the process
    world. ``group``: the process group of its replica's ``model`` axis,
    ``data_group`` that of its model coordinate across the replicas,
    ``mesh_group`` that of every rank of the mesh (all None for an
    abstract mesh; None too for a rank outside the mesh); ``groups``: the
    process world's groups by their tuple of ranks, shared by every mesh
    of that world (None for an abstract mesh); ``debug`` turns on the
    cross-rank checks (``routing.check_plan_replicated``)."""
    shape: dict
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: object = None
    backend: Optional[str] = None
    debug: bool = False
    data_group: object = None
    mesh_group: object = None
    groups: Optional[dict] = field(default=None, repr=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (row-major, last axis
        fastest)."""
        inner = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // inner) % self.shape[name]
            inner *= self.shape[name]
        return 0

    @property
    def member(self) -> bool:
        """Whether this rank belongs to the mesh (ranks ``[0, size)``)."""
        return self.rank < self.size

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data_size(self) -> int:
        """The replica count: the product of the data axes (``pod``,
        ``data``)."""
        return math.prod(self.shape.get(a, 1) for a in DATA_AXES)

    @property
    def data_rank(self) -> int:
        """This rank's replica: its index over the data axes, row-major."""
        r = 0
        for a in DATA_AXES:
            r = r * self.shape.get(a, 1) + self.coord(a)
        return r

    @property
    def model_rank(self) -> int:
        return self.coord("model")

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh of the given axis sizes with no process group (rank 0): the
    sharding rules read its sizes only."""
    return Mesh(dict(zip(axes, (int(s) for s in shape))))
