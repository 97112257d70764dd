"""The port's device mesh: named axes over ``torch.distributed`` ranks.

A ``Mesh`` describes one rank of a job: the axis sizes (``{"data": D,
"model": M}``), this rank's index, its device and the process group its
collectives run on. ``with mesh:`` makes it the active mesh, as the JAX
package's ``with mesh:`` does: the model code reads it
(``active_mesh()``) to take its rank's heads, columns and vocabulary rows
and to complete the partial sums (``runtime/collectives.py``). The
ranks are laid out row-major over the axes, the last axis fastest.

``abstract_mesh`` gives a mesh without processes, for the sharding rules
alone; ``launch/mesh.py`` builds a rank's mesh over a process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

_ACTIVE: list = []              # the ``with mesh:`` stack


def active_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered with ``with mesh:`` (None outside)."""
    return _ACTIVE[-1] if _ACTIVE else None


@dataclass
class Mesh:
    """One rank's view of a (data, model) mesh. ``shape`` maps each axis
    name to its size, in axis order. ``group``: the process group of the
    ``model`` axis (None for an abstract mesh); ``debug`` turns on the
    cross-rank checks (``routing.check_plan_replicated``)."""
    shape: dict
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: object = None
    backend: Optional[str] = None
    debug: bool = False

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
    def model_size(self) -> int:
        return self.shape.get("model", 1)

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
