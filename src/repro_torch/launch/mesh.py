"""Building a rank's mesh over ``torch.distributed``.

``make_mesh`` joins (or creates) the process group with the backend the
caller names: ``"gloo"`` (CPU processes, or ranks that share one card:
NCCL refuses two ranks on one device) or ``"nccl"`` (one card per rank).
Nothing is chosen silently. The ``Mesh`` it returns, the ``with mesh:``
stack and ``abstract_mesh`` live in ``runtime/mesh.py``, which the model
code reads.

The JAX package's ``make_production_mesh`` describes a TPU pod (16 x 16
chips). The port's counterpart states H100 counts: one node of 8 cards
as ``(data=1, model=8)``, NCCL over NVLink. That shape is untested: the
machines this port was checked on hold one card. A config whose q- or
kv-heads do not divide 8 (Qwen2-7B's 28 q-heads, for one) also waits for
padded heads on the kernels (ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.mesh import Mesh

BACKENDS = ("gloo", "nccl")
NODE_CARDS = 8                  # H100s of one node (an HGX board)


def make_mesh(shape, axes, *, backend: str, rank: int,
              init_method: Optional[str] = None, device=None,
              debug: bool = False, timeout: Optional[float] = None) -> Mesh:
    """This rank's mesh of ``shape`` over ``axes``. Initializes the
    default process group with ``backend`` (world size: the mesh's size)
    unless one exists, which must then match. ``init_method``: e.g.
    ``tcp://localhost:<port>`` (nothing tells a program of a cluster).
    ``device``: this rank's device (default the CPU). ``timeout``: seconds
    after which a collective that a rank never joins raises (default
    ``torch.distributed``'s). A data axis above 1 is refused (ROADMAP
    Queue A item 11, the data axis)."""
    import datetime

    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    mesh = Mesh(dict(zip(axes, shape)), int(rank),
                torch.device(device or "cpu"), None, backend, debug)
    if mesh.size // mesh.model_size > 1:
        raise NotImplementedError(
            "a data axis above 1 arrives with ROADMAP Queue A item 11 (the "
            "data axis and the scheduler's replicas)")
    if dist.is_initialized():
        if dist.get_world_size() != mesh.size or dist.get_rank() != rank \
                or dist.get_backend() != backend:
            raise ValueError(
                f"the process group ({dist.get_backend()}, rank "
                f"{dist.get_rank()} of {dist.get_world_size()}) does not "
                f"match the mesh ({backend}, rank {rank} of {mesh.size})")
    else:
        kw = {} if timeout is None else dict(
            timeout=datetime.timedelta(seconds=timeout))
        dist.init_process_group(backend, init_method=init_method,
                                world_size=mesh.size, rank=rank, **kw)
    mesh.group = dist.group.WORLD
    return mesh


def destroy(mesh: Mesh) -> None:
    """Leave the process group the mesh made."""
    import torch.distributed as dist
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()
    mesh.group = None


def make_production_mesh() -> tuple:
    """The (shape, axes) of the port's production mesh: one node of
    ``NODE_CARDS`` H100s as (data=1, model=8). A description only
    (untested: see the module docstring); ``make_mesh`` builds a rank's
    mesh from it."""
    return (1, NODE_CARDS), ("data", "model")
