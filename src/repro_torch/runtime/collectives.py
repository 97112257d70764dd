"""The collectives of tensor-parallel serving, on the active mesh's
``model`` group: ``all_reduce_sum`` completes a row-parallel product's
partial sums (attention's ``wo``, the MLP's ``wo``, the vocab-sharded
embedding lookup) and ``all_gather`` joins the vocabulary shards of the
logits.

Gloo runs on host memory: under the ``gloo`` backend a CUDA tensor is
staged through pinned host memory (copied out, reduced or gathered on the
host, copied back). That is how ranks that share one card exchange data
(NCCL refuses two ranks on one device); it is the transport of that
arrangement, not a fallback. Under ``nccl`` the device tensor goes to the
collective as it is. A failed collective raises (``torch.distributed``'s
error, or ``RuntimeError`` for a rank whose copy differs in
``assert_replicated``).

Every call outside a mesh, or on a model axis of 1, returns its input
untouched. ``stats()`` counts the calls, their bytes and their wall time
(each call waits for its result, so the time includes the device's wait
for it); ``reset_stats()`` zeroes them.
"""
from __future__ import annotations

import time

import torch

from repro_torch.runtime.mesh import active_mesh

_STATS = {"all_reduce": 0, "all_gather": 0, "bytes": 0, "seconds": 0.0}


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(all_reduce=0, all_gather=0, bytes=0, seconds=0.0)


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
