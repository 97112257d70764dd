"""Elastic scaling: re-mesh a running job onto a different device count.

The port's counterpart of the JAX package's ``runtime/elastic.py``: the
mesh shapes a job may move to (``valid_mesh_shapes``), and the live
re-mesh of the serving state (``rescale_serving_state``, which
``ServingEngine.reshard`` calls). The JAX package re-places global arrays
with ``device_put``; in the port each rank holds only its slice, so a
re-mesh gathers every leaf over the old mesh through the host
(``gather``: one all-gather per leaf, ``collectives.gather_mesh``) and
each rank of the new mesh takes its slice by the same logical rules
(``reshard``), which are expressed against axis names, not sizes.
Re-meshing the training state (``rescale_training_state``) arrives with
training on a mesh (ROADMAP Queue A item 11, part 4).
"""
from __future__ import annotations

import torch

from repro_torch.runtime import collectives as C
from repro_torch.runtime import sharding as SH


_AS_BYTES = (torch.bool, torch.bfloat16, torch.float16, torch.int16)


def valid_mesh_shapes(n_devices: int, model_axis: int):
    """The (data, model) shapes available after losing or gaining hosts:
    the model axis kept, halved or doubled where it divides the device
    count (the controller picks the largest batch-preserving one)."""
    out = []
    for m in (model_axis, model_axis // 2, model_axis * 2):
        if m and n_devices % m == 0:
            out.append((n_devices // m, m))
    return out


def to_device(tree, device):
    """Every tensor of a nested dict / list on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return [to_device(v, device) for v in tree]


def gather(tree, specs, mesh):
    """Every tensor of ``tree`` (each rank's slice by ``specs`` on
    ``mesh``) made whole on the host of every rank of the mesh: one
    all-gather per leaf over the mesh (bool and 16-bit leaves travel
    as their bytes), reassembled by ``sharding.unshard_leaf``. Every rank of
    the mesh calls it with the same tree structure."""
    if isinstance(tree, dict):
        return {k: gather(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather(v, s, mesh) for v, s in zip(tree, specs)]
    x = tree.detach().cpu()
    raw = x.dtype in _AS_BYTES             # gloo has no collective for them
    x = x.view(torch.uint8) if raw else x  # last dim x element size
    full = SH.unshard_leaf(C.gather_mesh(x, mesh), specs, mesh)
    return full.view(tree.dtype) if raw else full


def reshard(tree, mesh, specs, device=None):
    """The rank's slice of a whole host ``tree`` on ``mesh`` by ``specs``
    (the whole tree when ``mesh`` is None: one device), on ``device``."""
    if mesh is None:
        return tree if device is None else to_device(tree, device)
    return SH.shard_tree(tree, specs, mesh, device)


def rescale_serving_state(params, router_params, caches, cfg, old_mesh,
                          new_mesh, *, template, device):
    """Re-mesh live SERVING state without a restart, from the rank's
    slices on ``old_mesh`` to its slices on ``new_mesh`` (``None``: one
    device, the whole trees): base params follow the TP rules, routers
    stay whole, and the live slot caches follow the cache rules (slot rows
    or pages over the data axes, kv-heads over ``model``). The cache
    contents ARE the in-flight requests, so they are moved, never
    dropped. ``template``: the caches' whole shapes (e.g. on the meta
    device), which the cache rules read. The weights keep the rank's
    shard when the model axis stays (every rank keeps its model
    coordinate), else are gathered like the caches and re-sliced (every
    rule split divides its axis, as the kernels require). Every rank of
    ``old_mesh`` calls it; a rank outside ``new_mesh`` gets
    ``(None, None, None)``."""
    stays = new_mesh.member if new_mesh is not None else old_mesh.rank == 0
    new_m = new_mesh.model_size if new_mesh is not None else 1
    whole_params = None
    if old_mesh.model_size != new_m:     # decided alike on every rank
        whole_params = (params if old_mesh.model_size == 1 else gather(
            params, SH.param_specs(params), old_mesh))
    whole = gather(caches, SH.cache_specs_tree(template, cfg, old_mesh),
                   old_mesh)
    if not stays:
        return None, None, None
    if whole_params is not None:
        params = reshard(whole_params, new_mesh,
                         None if new_mesh is None
                         else SH.param_specs(whole_params, new_mesh), device)
    caches = reshard(whole, new_mesh,
                     None if new_mesh is None
                     else SH.cache_specs_tree(template, cfg, new_mesh), device)
    return params, router_params, caches
