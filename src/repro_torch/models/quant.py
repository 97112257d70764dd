"""Symmetric int8 quantization of the serving engine's KV caches and base
weights (``ElasticSpec.kv_dtype`` / ``ElasticSpec.weight_dtype``): the
port's copy of the JAX package's ``models/quant.py``, the same protocol and
the same bytes.

* KV rows are quantized ONCE, at the cache write site, per (token, head):
  ``scale = max|x| over Dh / 127`` (f32), ``q = round(x / scale)`` clipped to
  [-127, 127]. The scale is a sibling leaf next to the int8 tensor (ring:
  ``kscale``/``vscale`` (B, L, K); paged pool: (N, page_size, K)), so row
  splices, page copies, forks and preemption replays move the exact stored
  bytes: re-quantizing a dequantized value drifts, copying (int8, scale)
  pairs cannot.
* Weights are quantized once at engine init, per OUTPUT channel (the axes
  the consuming contraction does not reduce), with an f32 ``{name}_scale``
  sibling leaf.
* Rounding is half to even (``torch.round``, as ``jnp.round`` does it:
  0.5 -> 0, 1.5 -> 2, 2.5 -> 2), so identical f32 inputs give the JAX
  package's codes bit for bit. (Its docstring says "round-half-away"; its
  code rounds half to even, and this copy follows the code.)
* Dequantization is ``q.float() * scale``: inside the CUDA kernels it
  happens in registers after the tile load, in the kernels' plain versions
  on whole tensors.

``"fp32"`` means the native config dtype, no quantization; ``"bf16"`` is a
plain cast (no scales: bf16 keeps f32's exponent range).

The plain matrix products outside the kernels (the q/k/v/o projections,
the decode MLP, ``moe_decode`` and the shared expert) do not materialize
``q.float() * scale``: ``widened`` casts the int8 codes to the activation
dtype (exact, |q| <= 127) and ``scaled`` multiplies the product's output
channels by the scale in f32. A per-output-channel scale commutes with the
contraction, so this is the reference's ``maybe_dequant`` product up to
rounding, and it writes 2 bytes a parameter for bf16 activations where a
widened f32 copy would write 4 and read them again.
"""
from __future__ import annotations

import torch

KV_DTYPES = ("fp32", "bf16", "int8")
WEIGHT_DTYPES = ("fp32", "bf16", "int8")

INT8_MAX = 127.0


def check_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return kv_dtype


def check_weight_dtype(weight_dtype: str) -> str:
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, "
                         f"got {weight_dtype!r}")
    return weight_dtype


def kv_store_dtype(kv_dtype: str, cfg_dtype: torch.dtype) -> torch.dtype:
    """Storage dtype of the k/v cache leaves for a given ``kv_dtype``."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "bf16":
        return torch.bfloat16
    return cfg_dtype


def quantize_kv(x):
    """Per-(token, head) symmetric int8: x (..., Dh) -> (q int8 (..., Dh),
    scale f32 (...,)). Deterministic, so identical f32 inputs always give
    identical stored bytes (the bit-stability that prefix sharing and
    replay rely on)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT8_MAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=None):
    """Inverse of ``quantize_kv`` in f32, optionally cast to ``dtype``."""
    x = q.float() * scale[..., None].float()
    return x if dtype is None else x.to(dtype)


# ------------------------------ weights --------------------------------------
#
# Reduced (input) axes are END-RELATIVE:
#   * attention wq/wk/wv (..., D, H, Dh): reduce D        -> scale (..., H, Dh)
#   * attention wo       (..., H, Dh, D): reduce (H, Dh)  -> scale (..., D)
#   * mlp wi/wg          (..., D, F):     reduce D        -> scale (..., F)
#   * mlp wo             (..., F, D):     reduce F        -> scale (..., D)
#   * expert stacks      (..., E, D, F) / (..., E, F, D): reduce the middle
# "wo" is ambiguous between the attention and MLP shapes; both directions
# tell them apart by the SIBLING names in the param dict (an attention dict
# holds "wq", an MLP dict "wi").


def _reduce_axes(node: dict, name: str):
    """End-relative reduced axes of weight ``name`` in param dict ``node``,
    or None if the name is not a quantizable base matrix."""
    if name in ("wq", "wk", "wv"):
        return (-3,)
    if name == "wo" and "wq" in node:
        return (-3, -2)                    # attention out-projection
    if name in ("wi", "wg", "wo") and "wi" in node:
        return (-2,)                       # dense MLP / expert stacks
    return None


def _expand(scale, reduce_axes):
    """``scale`` with size-1 dimensions at the end-relative ``reduce_axes``
    of the weight it belongs to."""
    n = scale.dim() + len(reduce_axes)
    for a in sorted(reduce_axes):
        scale = scale.unsqueeze(n + a)
    return scale


def quantize_weight(w, reduce_axes):
    """Per-output-channel symmetric int8: the scale has w's shape minus the
    reduced axes."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axes)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT8_MAX
    q = torch.clamp(torch.round(wf / _expand(scale, reduce_axes)),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_weight(q, scale, reduce_axes):
    return q.float() * _expand(scale.float(), reduce_axes)


def maybe_dequant(p: dict, name: str, dtype=None):
    """Weight ``name`` of param dict ``p``, dequantized when a
    ``{name}_scale`` sibling is present (engine-quantized params), cast to
    ``dtype`` when given. The reference's accessor, kept for the plain
    paths that need the whole weight; the port's matrix products use
    ``widened`` and ``scaled``."""
    w = p[name]
    scale = p.get(name + "_scale")
    if scale is None:
        return w
    wd = dequantize_weight(w, scale, _reduce_axes(p, name))
    return wd if dtype is None else wd.to(dtype)


def widened(p: dict, name: str, dtype):
    """Weight ``name`` as a matrix-product operand in ``dtype``: int8 codes
    widened (exact), a bf16-stored weight cast, a native one as it is."""
    w = p[name]
    return w if w.dtype == dtype else w.to(dtype)


def scaled(y, p: dict, name: str, shape=None):
    """The product ``y`` of ``widened(p, name, ...)`` with its output
    channels multiplied by ``{name}_scale`` in f32 (``shape``: the scale's
    broadcast shape, when it is not ``y``'s trailing dimensions); ``y`` as
    it is when the weight has no scale."""
    scale = p.get(name + "_scale")
    if scale is None:
        return y
    if shape is not None:
        scale = scale.reshape(shape)
    return (y.float() * scale).to(y.dtype)


def quantize_params_tree(params, weight_dtype: str):
    """Engine-init transform: quantize or cast the base attention
    projections and MLP/MoE matrices (expert stacks included) of a param
    tree, leaving routers, norms, embeddings, LoRA and biases as they are.
    int8 adds f32 ``{name}_scale`` sibling leaves; bf16 is a plain cast.
    Returns a NEW tree; the input is never mutated."""
    check_weight_dtype(weight_dtype)
    if weight_dtype == "fp32":
        return params

    def walk(node):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list, tuple)):
                out[k] = walk(v)
                continue
            axes = _reduce_axes(node, k) \
                if torch.is_tensor(v) and v.dim() >= 2 else None
            if axes is None:
                out[k] = v
            elif weight_dtype == "bf16":
                out[k] = v.to(torch.bfloat16)
            else:
                out[k], out[k + "_scale"] = quantize_weight(v, axes)
        return out

    return walk(params)
