"""Weight interop with the JAX package's checkpoint layout.

The JAX checkpointer flattens a tree to ``{keystr: np.ndarray}``, with keys
such as ``"['params']['scan'][0]['attn']['wq']"``. Its layer stack is stored
per pattern position: ``scan[j]`` leaves carry a leading period dimension P
and hold layer ``i = p * period_len + j``; ``tail[r]`` is layer
``P * period_len + r``. The port keeps one dict per layer
(``params["layers"][i]``); these functions convert between the two, leaf
names and layouts unchanged, whatever the layer tree holds: a native MoE
layer's ``mlp`` (``router``, ``wi``/``wg``/``wo`` as ``(E, ...)`` stacks,
``shared.{wi,wg,wo}``) and the ``expert`` routers come over like any other
leaf. A moefied spec adds no base weights (the experts are views of the
dense MLP). Engine-quantized trees come over the same way: int8 weights
keep their codes and their f32 ``{name}_scale`` siblings, leaf for leaf.
Serving state comes over too: a JAX ring cache or paged KV pool tree, with
an int8 cache's ``kscale``/``vscale`` leaves (``caches_from_numpy``).
Given a ``mesh`` (``runtime/mesh.py``), the base params and the caches
keep the rank's slice by the sharding rules (``runtime/sharding.py``):
the params their model shard (whole over the data axes), the caches the
replica's slot rows or pages at the rank's kv-heads; routers, norms and
LoRA stay whole, as the JAX package's default ``P()`` rule keeps them.
The context families add leaves beside the layer stack (``in_proj``, the
``vlm`` router) and inside it (an ``xattn`` layer's ``xnorm``/``xattn``
params and its context cache), which come over like any other, and an
encoder-decoder nests its encoder's tree (params or routers, with its own
scan/tail split by the encoder's pattern) under ``encoder``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import build_pattern, stack_layers, unstack_layers
from repro_torch.runtime import sharding as SH

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse(key: str) -> list:
    path = [m.group(1) if m.group(1) is not None else int(m.group(2))
            for m in _KEY.finditer(key)]
    if "".join(m.group(0) for m in _KEY.finditer(key)) != key or not path:
        raise ValueError(f"not a keystr path: {key!r}")
    return path


def _listify(node):
    """Dicts keyed 0..n-1 (the flattened lists) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree_to_torch(node, device):
    if isinstance(node, dict):
        return {k: _tree_to_torch(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to_torch(v, device) for v in node]
    return _to_tensor(node, device)


def _layers_from(tree: dict, P: int) -> list:
    return unstack_layers(tree.get("scan", []), tree.get("tail", []), P)


def _from_layered(tree: dict, cfg, spec) -> dict:
    """A JAX layered tree (``scan``/``tail``) as the port's (``layers``);
    a nested ``encoder`` tree by the encoder's own pattern."""
    _, P, _ = build_pattern(cfg, spec)
    out = {k: v for k, v in tree.items()
           if k not in ("scan", "tail", "encoder")}
    out["layers"] = _layers_from(tree, P)
    if "encoder" in tree:
        out["encoder"] = _from_layered(tree["encoder"], cfg.encoder, spec)
    return out


def _tree_from_flat(flat: dict, device):
    root = {}
    for key, arr in flat.items():
        path = _parse(key)
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return _tree_to_torch(_listify(root), device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def params_from_numpy(flat: dict, cfg, spec=None, *, device=None,
                      mesh=None):
    """``flat``: the checkpointer's ``_flatten`` of ``{"params": params,
    "routers": routers}`` (or of the params tree alone). Returns the port's
    (params, routers); routers is None when ``flat`` has none. bf16 leaves
    keep their bits. ``mesh``: the params keep the rank's slice (taken on
    the host, before the copy to ``device``); the routers stay whole."""
    device = resolve_device(device)
    tree = _tree_from_flat(flat, "cpu" if mesh is not None else device)
    if "params" in tree:
        ptree, rtree = tree["params"], tree.get("routers")
    else:
        ptree, rtree = tree, None
    routers = None if rtree is None else _from_layered(rtree, cfg, spec)
    params = _from_layered(ptree, cfg, spec)
    if mesh is not None:
        params = SH.shard_params(params, mesh, device=device)
        routers = None if routers is None else _to_device(routers, device)
    return params, routers


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:     # numpy has no bf16: widen exactly
        t = t.float()
    return t.numpy()


def _flatten_into(out: dict, prefix: str, node) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten_into(out, f"{prefix}['{k}']", v)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _flatten_into(out, f"{prefix}[{i}]", v)
    else:
        out[prefix] = _to_numpy(node)


def layered_tree(cfg, spec, trees: dict) -> dict:
    """``{name: port tree with "layers"}`` in the JAX layout: each tree's
    layers as ``scan`` stacks (a leading period dimension) and a ``tail``,
    tensor leaves where the port's are."""
    period, _, _ = build_pattern(cfg, spec)
    out = {}
    for name, tree in trees.items():
        scan, tail = stack_layers(tree["layers"], len(period))
        rest = {k: v for k, v in tree.items() if k not in ("layers",
                                                            "encoder")}
        out[name] = {**rest, "scan": scan, "tail": tail}
        if "encoder" in tree:
            out[name]["encoder"] = layered_tree(
                cfg.encoder, spec, {"encoder": tree["encoder"]})["encoder"]
    return out


def layered_to_numpy(out: dict, cfg, spec, trees: dict) -> dict:
    """Flatten ``{name: port tree with "layers"}`` into ``out`` in the JAX
    layout (``['name']['scan'][j]...`` keys)."""
    _flatten_into(out, "", layered_tree(cfg, spec, trees))
    return out


def params_to_numpy(params: dict, routers, cfg, spec=None) -> dict:
    """Inverse of ``params_from_numpy``: the JAX layout of
    ``{"params": params, "routers": routers}`` as ``{keystr: ndarray}``
    (bf16 leaves widened to f32, exactly)."""
    trees = {"params": params}
    if routers is not None:
        trees["routers"] = routers
    return layered_to_numpy({}, cfg, spec, trees)


# The JAX trainer checkpoints {"router": routers, "opt_m": m, "opt_v": v}
# with the optimizer step beside them (launch/train.py ``save``).
TRAIN_TREES = ("router", "opt_m", "opt_v")


def train_state_tree(state, cfg, spec=None) -> dict:
    """The tree the JAX trainer checkpoints for a port ``TrainState``:
    ``{"router", "opt_m", "opt_v"}`` in the JAX layout, tensor leaves on
    the state's device (the optimizer step goes beside it)."""
    return layered_tree(cfg, spec, dict(zip(TRAIN_TREES, (
        state.router_params, state.opt.m, state.opt.v))))


def train_state_from_tree(tree: dict, opt_step: int, cfg, spec=None):
    """Inverse of ``train_state_tree``: the port's ``TrainState`` on the
    device of the tree's tensors (each layer's leaves are views into the
    stacks), ``opt_step`` its step. Bit-exact."""
    from repro_torch.optim import AdamWState
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.training import TrainState
    rp, m, v = (_from_layered(tree[n], cfg, spec) for n in TRAIN_TREES)
    step = torch.tensor(int(opt_step), dtype=torch.int32,
                        device=tree_leaves(m)[0].device)
    return TrainState(rp, AdamWState(step, m, v), None)


def train_state_from_numpy(flat: dict, opt_step: int, cfg, spec=None, *,
                           device=None):
    """A JAX training state as the port's ``TrainState``: ``flat`` is the
    checkpointer's ``_flatten`` of ``{"router": routers, "opt_m": m,
    "opt_v": v}`` (the AdamWState's moment trees), ``opt_step`` its step.
    Bit-exact."""
    device = resolve_device(device)
    return train_state_from_tree(_tree_from_flat(flat, device), opt_step,
                                 cfg, spec)


def train_state_to_numpy(state, cfg, spec=None):
    """Inverse of ``train_state_from_numpy``: (flat, opt_step)."""
    out = {}
    _flatten_into(out, "", train_state_tree(state, cfg, spec))
    return out, int(state.opt.step)


def caches_from_numpy(tree: dict, cfg, *, device=None, mesh=None) -> dict:
    """A JAX KV cache tree (``repro.models.cache_init``'s ring caches or
    ``paged_cache_init``'s pools: ``{"scan": [...], "tail": [...]}``, numpy
    leaves; scan leaves carry a leading period dimension) as the port's
    ``{"layers": [{"attn": {...}}, ...]}`` (ring: ``k``, ``v``, ``valid``,
    ``pos``; paged: ``kp``, ``vp``, ``pvalid``; int8: ``kscale`` and
    ``vscale`` beside them), bit for bit. The JAX caches stack by the
    layer pattern alone (no elastic spec). ``mesh``: the rank's slice by
    the cache rules (its replica's slot rows or pages, its kv-heads)."""
    device = resolve_device(device)
    _, P, _ = build_pattern(cfg, None)
    caches = {"layers": _layers_from(_tree_to_torch(tree, device), P)}
    return caches if mesh is None else SH.shard_caches(caches, cfg, mesh)
