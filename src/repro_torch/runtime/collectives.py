"""The collectives of serving on a (data, model) mesh.

On the active mesh's ``model`` group (the rank's replica):
``all_reduce_sum`` completes a row-parallel product's partial sums
(attention's ``wo``, the MLP's ``wo``, the vocab-sharded embedding
lookup) and ``all_gather`` joins the vocabulary shards of the logits.

Across the replicas: ``exchange`` all-gathers a few integers per slot (a
decode step's sampled tokens and ``active`` flags, or admissions' first
tokens) over the rank's ``data`` group, the only cross-replica
calls of an engine step, so every rank's host scheduler sees every
replica's tokens. ``gather_mesh`` (every rank of the mesh) and
``broadcast_int`` serve the live re-mesh and the open loop's arrivals.

Gloo runs on host memory: under the ``gloo`` backend a CUDA tensor is
staged through pinned host memory (copied out, reduced or gathered on the
host, copied back). That is how ranks that share one card exchange data
(NCCL refuses two ranks on one device); it is the transport of that
arrangement, not a fallback. Under ``nccl`` the device tensor goes to the
collective as it is. A failed collective raises (``torch.distributed``'s
error, or ``RuntimeError`` for a rank whose copy differs in
``assert_replicated``).

Every model-axis call outside a mesh, or on a model axis of 1, returns
its input untouched; ``exchange`` does so on a data axis of 1. ``stats()``
counts the model-axis calls, their bytes and their wall time (each call
waits for its result, so the time includes the device's wait for it), and
apart from them the data-axis and mesh-wide ones (``data_*``);
``reset_stats()`` zeroes them.
"""
from __future__ import annotations

import time

import torch

from repro_torch.runtime.mesh import active_mesh

_ZERO = {"all_reduce": 0, "all_gather": 0, "bytes": 0, "seconds": 0.0,
         "data_calls": 0, "data_bytes": 0, "data_seconds": 0.0}
_STATS = dict(_ZERO)


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(_ZERO)


def tp_rank_size(mesh=None) -> tuple:
    """(this rank's index on the ``model`` axis, the axis size) of
    ``mesh`` or the active mesh; (0, 1) outside one."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 0, 1
    return mesh.model_rank, mesh.model_size


def _staged(mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _active(mesh):
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.model_size == 1:
        return None
    if mesh.group is None:
        raise RuntimeError("a collective on an abstract mesh (no process "
                           "group): build the mesh with make_mesh")
    return mesh


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` axis, as a new tensor on
    ``x``'s device (every rank gets the same bits)."""
    import torch.distributed as dist
    mesh = _active(mesh)
    if mesh is None:
        return x
    t0 = time.perf_counter()
    staged = _staged(mesh, x)
    buf = _to_host(x) if staged else x.contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    out = buf.to(x.device) if staged else buf
    _STATS["all_reduce"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    _STATS["seconds"] += time.perf_counter() - t0
    return out


def all_gather(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist
    mesh = _active(mesh)
    if mesh is None:
        return x
    t0 = time.perf_counter()
    staged = _staged(mesh, x)
    buf = _to_host(x) if staged else x.contiguous()
    outs = [torch.empty_like(buf) for _ in range(mesh.model_size)]
    dist.all_gather(outs, buf, group=mesh.group)
    out = torch.cat(outs, dim=dim)
    out = out.to(x.device) if staged else out
    _STATS["all_gather"] += 1
    _STATS["bytes"] += x.numel() * x.element_size() * mesh.model_size
    _STATS["seconds"] += time.perf_counter() - t0
    return out


def assert_replicated(x: torch.Tensor, what: str, mesh=None) -> None:
    """Raise unless every rank of the ``model`` axis holds the same bits
    of ``x`` (a debug check: one all-gather)."""
    mesh = _active(mesh)
    if mesh is None:
        return
    flat = x.reshape(1, -1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    allx = all_gather(flat, dim=0, mesh=mesh)
    if not bool((allx == allx[:1]).all()):
        raise RuntimeError(f"{what} differs across the model axis on rank "
                           f"{mesh.rank}")


# --------------------------- across the replicas -----------------------------

def _host_side(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend takes it: host memory under gloo (staged
    through pinned memory from a card), the rank's device under nccl."""
    if mesh.backend == "nccl":
        return x.to(mesh.device).contiguous()
    return _to_host(x) if x.device.type == "cuda" else x.contiguous().clone()


def _gather(x: torch.Tensor, group, n: int, mesh) -> list:
    import torch.distributed as dist
    t0 = time.perf_counter()
    buf = _host_side(mesh, x)
    outs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(outs, buf, group=group)
    outs = [o.to(x.device) for o in outs]
    _STATS["data_calls"] += 1
    _STATS["data_bytes"] += x.numel() * x.element_size() * n
    _STATS["data_seconds"] += time.perf_counter() - t0
    return outs


def exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every replica's ``x`` (the rank's per-slot rows) concatenated along
    dim 0 in replica order, over the rank's ``data`` group: flat slot
    order, since replica d holds slots ``[d*B/D, (d+1)*B/D)``. A data axis
    of 1 returns ``x``."""
    if mesh is None or mesh.data_size == 1:
        return x
    if mesh.data_group is None:
        raise RuntimeError("an exchange on a mesh without process groups: "
                           "build the mesh with make_mesh")
    return torch.cat(_gather(x, mesh.data_group, mesh.data_size, mesh))


def gather_mesh(x: torch.Tensor, mesh) -> list:
    """Every rank's ``x`` over the whole mesh, as a list in world-rank
    order (a live re-mesh reassembles the slot state from it). Every
    rank's ``x`` must have the same shape and dtype."""
    return _gather(x, mesh.mesh_group, mesh.size, mesh)


def broadcast_int(v: int, mesh) -> int:
    """Mesh rank 0's ``v`` on every rank of the mesh (the open loop's
    arrivals, decided on one clock)."""
    import torch.distributed as dist
    if mesh is None or mesh.size == 1:
        return int(v)
    t = torch.tensor([int(v)], dtype=torch.int64)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    dist.broadcast(t, src=0, group=mesh.mesh_group)
    _STATS["data_calls"] += 1
    _STATS["data_bytes"] += 8 * mesh.size
    return int(t.item())
