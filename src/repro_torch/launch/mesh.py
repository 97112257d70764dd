"""Building a rank's mesh over ``torch.distributed``.

``make_mesh`` joins (or creates) the process group with the backend the
caller names: ``"gloo"`` (CPU processes, or ranks that share one card:
NCCL refuses two ranks on one device) or ``"nccl"`` (one card per rank).
Nothing is chosen silently. It builds a (data=D, model=M) mesh over a
world of D*M processes: each replica's model group, each model
coordinate's data group and the mesh's own group (``runtime/mesh.py``).
``remesh`` builds a mesh of another shape over the same world for a live
re-mesh (``ServingEngine.reshard``). The ``Mesh`` they return, the ``with
mesh:`` stack and ``abstract_mesh`` live in ``runtime/mesh.py``, which the
model code reads.

``torch.distributed.new_group`` must be entered by every process of the
world, in the same order, members or not. So ``make_mesh`` creates the
groups of every mesh shape the world holds, once, in one fixed order,
with the mesh's timeout, and ``remesh`` only selects among them: the
ranks a re-mesh leaves out drain and stop, and no later re-mesh waits
for them.

The JAX package's ``make_production_mesh`` describes a TPU pod (16 x 16
chips). The port's counterpart states H100 counts: two nodes of 8 cards
as ``(data=2, model=8)``, a replica per node, NCCL over NVLink inside a
node. That shape is a description only: the machines this port was
checked on hold one card. A config whose q- or kv-heads do not divide 8
(Qwen2-7B's 28 q-heads, for one) also waits for padded heads on the
kernels (ROADMAP Queue A item 11, part 7).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from repro_torch.runtime.mesh import Mesh

BACKENDS = ("gloo", "nccl")
NODE_CARDS = 8                  # H100s of one node (an HGX board)


def _rank_sets(D: int, M: int) -> tuple:
    """The ranks of a (D, M) mesh's groups: each replica's model group,
    each model coordinate's data group, and the whole mesh."""
    model = [tuple(range(d * M, (d + 1) * M)) for d in range(D)]
    data = [tuple(range(m, D * M, M)) for m in range(M)]
    return model, data, tuple(range(D * M))


def _world_groups(axes, world: int, timeout) -> dict:
    """Every group of every mesh shape over ``axes`` that ``world`` ranks
    hold, by its tuple of ranks, created in one fixed order (every world
    rank calls this once, from ``make_mesh``)."""
    import torch.distributed as dist
    kw = {} if timeout is None else dict(timeout=timeout)
    groups = {}
    for shape in itertools.product(range(1, world + 1), repeat=len(axes)):
        if math.prod(shape) > world:
            continue
        m = Mesh(dict(zip(axes, shape)))
        model, data, whole = _rank_sets(m.data_size, m.model_size)
        for ranks in (*model, *data, whole):
            if ranks not in groups:
                groups[ranks] = dist.new_group(list(ranks), **kw)
    return groups


def _select(mesh: Mesh) -> Mesh:
    """Keep this rank's groups of ``mesh`` from the world's (none for a
    rank outside the mesh)."""
    if mesh.member:
        model, data, whole = _rank_sets(mesh.data_size, mesh.model_size)
        mesh.group = mesh.groups[model[mesh.data_rank]]
        mesh.data_group = mesh.groups[data[mesh.model_rank]]
        mesh.mesh_group = mesh.groups[whole]
    return mesh


def _timeout(seconds):
    import datetime
    return None if seconds is None else datetime.timedelta(seconds=seconds)


def _check_axes(shape, axes) -> tuple:
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    if "model" in axes and axes[-1] != "model":
        raise ValueError(f"the model axis must be the last (fastest) axis, "
                         f"got {axes}")
    return shape, axes


def make_mesh(shape, axes, *, backend: str, rank: int,
              init_method: Optional[str] = None, device=None,
              debug: bool = False, timeout: Optional[float] = None) -> Mesh:
    """This rank's mesh of ``shape`` over ``axes`` (the ``model`` axis
    last). Initializes the default process group with ``backend`` (world
    size: the mesh's size) unless one exists, which must then match, and
    creates the mesh's groups. ``init_method``: e.g.
    ``tcp://localhost:<port>`` (nothing tells a program of a cluster).
    ``device``: this rank's device (default the CPU). ``timeout``: seconds
    after which a collective that a rank never joins raises (default
    ``torch.distributed``'s); every mesh ``remesh`` makes from this one
    keeps it."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    shape, axes = _check_axes(shape, axes)
    mesh = Mesh(dict(zip(axes, shape)), int(rank),
                torch.device(device or "cpu"), None, backend, debug)
    if dist.is_initialized():
        if dist.get_world_size() != mesh.size or dist.get_rank() != rank \
                or dist.get_backend() != backend:
            raise ValueError(
                f"the process group ({dist.get_backend()}, rank "
                f"{dist.get_rank()} of {dist.get_world_size()}) does not "
                f"match the mesh ({backend}, rank {rank} of {mesh.size})")
    else:
        kw = {} if timeout is None else dict(timeout=_timeout(timeout))
        dist.init_process_group(backend, init_method=init_method,
                                world_size=mesh.size, rank=rank, **kw)
    mesh.groups = _world_groups(axes, mesh.size, _timeout(timeout))
    return _select(mesh)


def remesh(mesh: Optional[Mesh], shape) -> Mesh:
    """This rank's mesh of another ``shape`` over the axes and the process
    world of ``mesh``, for a live re-mesh (``ServingEngine.reshard``): it
    takes the world's ranks ``[0, D'*M')``, and a rank past them gets a
    mesh it is not a ``member`` of (it drains and leaves the lockstep).
    Its groups are the world's, made by ``make_mesh`` with its timeout, so
    no rank has to join anything here. Raises ValueError when the shape
    needs more ranks than the world has, or when there is no world (a
    one-device engine)."""
    if mesh is None or mesh.groups is None:
        raise ValueError(f"a re-mesh onto {tuple(shape)} needs a process "
                         f"world: build the engines on a mesh (make_mesh)")
    shape, axes = _check_axes(shape, mesh.axis_names)
    new = dataclasses.replace(mesh, shape=dict(zip(axes, shape)), group=None,
                              data_group=None, mesh_group=None)
    world = max(max(r) for r in mesh.groups) + 1
    if new.size > world:
        raise ValueError(f"mesh {shape} needs {new.size} ranks, the process "
                         f"world has {world}")
    return _select(new)


def destroy(mesh: Mesh) -> None:
    """Leave the process group the mesh made."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh.group = mesh.data_group = mesh.mesh_group = mesh.groups = None


def make_production_mesh() -> tuple:
    """The (shape, axes) of the port's production mesh: two nodes of
    ``NODE_CARDS`` H100s as (data=2, model=8), a replica per node. A
    description only (see the module docstring); ``make_mesh`` builds a
    rank's mesh from it."""
    return (2, NODE_CARDS), ("data", "model")
