"""Logical -> per-rank sharding rules: Megatron-style tensor parallelism on
the ``model`` axis of a ``runtime.mesh.Mesh``.

An own copy of the JAX package's ``runtime/sharding.py`` rule table: the
rules are matched on a leaf's key path and rank, so one table covers
every architecture and both tree layouts (the port's per-layer
``['layers'][i]`` tree and the JAX package's stacked ``['scan'][j]``
tree, where each ``['scan']`` level adds a leading layer dimension that
the rule does not split). A spec is a plain tuple with one entry per
dimension: the axis name that dimension splits over, or None (replicated
along it); ``()`` replicates the whole leaf. ``shard_tree`` takes a
rank's slice of a tree by its specs.

What the JAX package gets from GSPMD the port does by hand in the model
(``runtime/collectives.py``): each rank holds q-heads ``[r*H/M,
(r+1)*H/M)`` and kv-heads ``[r*K/M, ...)``, the MLP's ``F/M`` columns and
the vocabulary's ``V/M`` rows, and the partial sums are all-reduced.
Parameters and routers replicate over the data axes; a cache's slot rows
(and a page pool's pages with their scale pools) split over them, so the
rank at (d, m) holds replica d's ``B/D`` slots or ``N/D`` pages.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch.runtime.mesh import DATA_AXES

MODEL = "model"


def batch_axes(mesh) -> tuple:
    """The data axes of ``mesh`` (none without a mesh)."""
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def _batch_entry(mesh):
    """The batch dim's spec entry: one axis by its name, several as a
    tuple, none as None (the JAX package's PartitionSpec normal form)."""
    ba = batch_axes(mesh)
    return ba[0] if len(ba) == 1 else (ba or None)


def data_axis_size(mesh) -> int:
    """The data-parallel replica count, ``Mesh.data_size`` (1 without a
    mesh)."""
    return 1 if mesh is None else mesh.data_size


def model_axis_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(MODEL, 1)


# ----------------------------- parameters -----------------------------------

_RULES = [
    # (regex on the key path's tail, rank, spec)
    (r"\['embed'\]$", 2, (MODEL, None)),                 # (V, D) vocab rows
    (r"\['lm_head'\]$", 2, (None, MODEL)),               # (D, V)
    (r"\['w[qkv]'\]$", 3, (None, MODEL, None)),          # (D, H, Dh) heads
    (r"\['b[qkv]'\]$", 2, (MODEL, None)),                # (H, Dh)
    (r"\['mlp'\].*\['w[ig]'\]$", 3, (None, None, MODEL)),  # MoE (E, D, Fe)
    (r"\['mlp'\].*\['wo'\]$", 3, (None, MODEL, None)),     # MoE (E, Fe, D)
    (r"\['mlp'\].*\['w[ig]'\]$", 2, (None, MODEL)),      # dense (D, F)
    (r"\['mlp'\].*\['wo'\]$", 2, (MODEL, None)),         # dense (F, D)
    (r"\['wo'\]$", 3, (MODEL, None, None)),              # attn out (H, Dh, D)
    (r"\['router'\]$", 2, ()),                           # tiny, replicated
    # mamba2
    (r"\['in_[zx]'\]$", 2, (None, MODEL)),
    (r"\['in_dt'\]$", 2, (None, MODEL)),
    (r"\['in_[bc]'\]$", 2, ()),
    (r"\['conv_x'\]$", 2, (None, MODEL)),
    (r"\['(a_log|d_skip|dt_bias)'\]$", 1, (MODEL,)),
    (r"\['norm_scale'\]$", 1, (MODEL,)),
    (r"\['out_proj'\]$", 2, (MODEL, None)),
    # rg-lru
    (r"\['w_[yx]'\]$", 2, (None, MODEL)),
    (r"\['conv_w'\]$", 2, (None, MODEL)),
    (r"\['conv_b'\]$", 1, (MODEL,)),
    (r"\['w_[ai]'\]$", 2, (None, MODEL)),
    (r"\['(b_a|b_i|lam)'\]$", 1, (MODEL,)),
    (r"\['w_out'\]$", 2, (MODEL, None)),
    # frontends
    (r"\['in_proj'\]$", 2, ()),
]


def _spec_for(key: str, ndim: int) -> tuple:
    """The rule of the first entry matching ``key`` at the UNSTACKED rank;
    each ``['scan']`` level prepends one None (the stacked-layer dim).
    Norms, routers, LoRA and scalars match none: replicated."""
    n_lead = key.count("['scan']")
    rank = ndim - n_lead
    for pat, r, spec in _RULES:
        if r == rank and re.search(pat, key):
            return (None,) * n_lead + spec
    return ()


def _fit_spec(spec: tuple, shape, mesh, relocate: bool = False) -> tuple:
    """Every split dim must divide its axis. A dim that does not is
    REPLICATED; ``relocate=True`` (caches only: memory, not collectives,
    binds there) moves its axis to the largest other dim that divides."""
    if mesh is None:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, ax in enumerate(dims):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= mesh.shape.get(a, 1)
        if shape[i] % size == 0:
            continue
        dims[i] = None
        if relocate:
            cands = [j for j, d in enumerate(dims)
                     if d is None and j != i and shape[j] % size == 0]
            if cands:
                dims[max(cands, key=lambda j: shape[j])] = ax
    return tuple(dims)


def _map(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_specs(params, mesh=None, prefix: str = ""):
    """A spec per leaf of ``params`` (the same nesting), divisibility-fit
    when a mesh is given. ``prefix``: the key path the tree sits under;
    the rules read only the tail."""
    return _map(params, lambda key, leaf: _fit_spec(
        _spec_for(key, leaf.dim()), tuple(leaf.shape), mesh), prefix)


# ------------------------------- caches -------------------------------------

def attn_kv_spec(cfg, mesh, lead: int = 0) -> tuple:
    """The one placement rule of a (B, L, K, Dh) ring-cache tensor (and of
    an (N, page_size, K, Dh) page pool, pages over the data axes):
    kv-heads over ``model`` when they divide it, else head_dim."""
    kv_div = cfg.n_kv_heads and cfg.n_kv_heads % model_axis_size(mesh) == 0
    tail = (None, MODEL, None) if kv_div else (None, None, MODEL)
    return (None,) * lead + (_batch_entry(mesh),) + tail


def kv_scale_spec(cfg, mesh, lead: int = 0) -> tuple:
    """An int8 cache's (B, L, K) scale leaf: kv-heads over ``model`` when
    they divide it (no head_dim to fall back on: replicated)."""
    kv_div = cfg.n_kv_heads and cfg.n_kv_heads % model_axis_size(mesh) == 0
    return (None,) * lead + (_batch_entry(mesh), None,
                             MODEL if kv_div else None)


def cache_specs_tree(caches, cfg, mesh):
    """Specs of a cache tree (ring caches, page pools, recurrent state),
    relocating a split that does not divide, as the JAX package's
    ``cache_specs_tree`` does."""
    ba = _batch_entry(mesh)

    def spec(key, leaf):
        nscan = key.count("['scan']")
        lead = (None,) * nscan
        if key.endswith("['kp']") or key.endswith("['vp']"):  # page pools
            s = attn_kv_spec(cfg, mesh, lead=nscan)
        elif key.endswith("['pvalid']"):
            s = lead + (ba, None)
        elif key.endswith("['kscale']") or key.endswith("['vscale']"):
            s = kv_scale_spec(cfg, mesh, lead=nscan)
        elif "['attn']" in key or "['xattn']" in key:
            if key.endswith("['valid']") or key.endswith("['pos']"):
                s = lead + (ba, None)
            else:
                s = attn_kv_spec(cfg, mesh, lead=nscan)
        elif key.endswith("['state']") and leaf.dim() - nscan == 4:  # ssm
            s = lead + (ba, MODEL, None, None)
        elif key.endswith("['state']"):                              # rglru
            s = lead + (ba, MODEL)
        elif key.endswith("['conv']"):
            s = lead + (ba, None, None)
        else:
            s = lead + (ba,)
        return _fit_spec(s, tuple(leaf.shape), mesh, relocate=True)

    return _map(caches, spec)


def slot_spec(ndim: int, dim: int, mesh) -> tuple:
    """The spec of a per-slot tensor whose ``dim`` indexes the serving
    slots (the engine's last tokens, a live policy leaf): that dim over
    the data axes, the rest replicated."""
    return tuple(_batch_entry(mesh) if i == dim else None
                 for i in range(ndim))


# ---------------------------- taking a slice --------------------------------

def split_dim(spec: tuple, axis: str = MODEL) -> Optional[int]:
    """The dim of ``spec`` that splits over ``axis`` (None: replicated)."""
    for i, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return i
    return None


def _splits(spec: tuple, mesh):
    """(dim, axis count, this rank's index over them) of every split dim
    of ``spec`` on ``mesh`` whose axes are above 1 (several axes on one dim
    combine row-major, as a PartitionSpec tuple does)."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size = mesh.shape.get(a, 1)
            n, i = n * size, i * size + mesh.coord(a)
        if n > 1:
            out.append((d, n, i))
    return out


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The rank's slice of ``x`` along every split dim of ``spec`` (the
    ``model`` dim by its model coordinate, a batch or page dim by its
    replica), contiguous (a copy, so the full tensor can be freed); ``x``
    itself when the leaf is replicated."""
    if mesh is None:
        return x
    out = x
    for d, n, i in _splits(spec, mesh):
        k = x.shape[d] // n
        out = out.narrow(d, i * k, k)
    return x if out is x else out.contiguous()


def unshard_leaf(shards: list, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice (``shards[r]`` is world
    rank r's ``shard_leaf`` on ``mesh``, r in ``[0, mesh.size)``): the
    inverse of ``shard_leaf``. Replicated dims take rank 0's copy."""
    ranks = [dataclasses.replace(mesh, rank=r) for r in range(mesh.size)]
    splits = [_splits(spec, m) for m in ranks]
    shape = list(shards[0].shape)
    for d, n, _ in splits[0]:
        shape[d] *= n
    full = shards[0].new_empty(shape)
    for r, sh in zip(range(mesh.size), shards):
        view = full
        for d, n, i in splits[r]:
            view = view.narrow(d, i * sh.shape[d], sh.shape[d])
        view.copy_(sh)
    return full


def shard_tree(tree, specs, mesh, device=None):
    """The rank's slice of every leaf of ``tree`` by ``specs`` (the same
    nesting, e.g. ``param_specs(tree, mesh)``), each moved to ``device``
    when one is given (slice a tree on the host, then copy the shard)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh, device) for v, s in zip(tree, specs)]
    x = shard_leaf(tree, specs, mesh)
    return x if device is None else x.to(device)


def shard_params(params, mesh, device=None):
    """The rank's slice of a base-parameter tree by the TP rules, on
    ``device`` when one is given. A mesh engine takes this shard."""
    return shard_tree(params, param_specs(params, mesh), mesh, device)


def shard_caches(caches, cfg, mesh):
    """The rank's slice of a cache tree by the cache rules."""
    return shard_tree(caches, cache_specs_tree(caches, cfg, mesh), mesh)
