"""Lossless dense-MLP -> MoE block decomposition (paper §4.1).

    y = W2 sigma(W1 x) = [W2,1 W2,2] sigma([W1,1; W1,2] x)

Split the up (and gate) projections by columns and the down projection by
rows. With every expert selected at weight 1 (the M * softmax
normalisation) the moefied module computes the dense one.

Both functions return VIEWS of their inputs, never copies: the block
moefies inside every forward, and in eager PyTorch a copy there would move
2 * D * F elements of every layer on every call. Expert ``e`` of the
moefied ``wi``/``wg`` is columns ``[e*Fe, (e+1)*Fe)`` of the dense
``(D, F)`` matrix (row stride F); expert ``e`` of ``wo`` is rows
``[e*Fe, (e+1)*Fe)`` of ``(F, D)``. The ``moe_gmm`` kernel takes strides,
so it reads the dense weights in place.
"""
from __future__ import annotations


def moefy_mlp(params: dict, n_experts: int) -> dict:
    """params: {'wi': (D,F), 'wo': (F,D), optional 'wg': (D,F)} ->
    {'wi': (E,D,F/E), 'wo': (E,F/E,D), optional 'wg': (E,D,F/E)}, views.
    Engine-quantized (int8) weights raise: the JAX package's ``moefy_mlp``
    drops their scale leaves, so the reference defines no int8 result for
    a moefied MLP, and the port invents none (ROADMAP Queue C)."""
    if any(k.endswith("_scale") for k in params):
        raise NotImplementedError(
            "a moefied MLP with int8 weights: the reference drops the scale "
            "leaves there and defines no result (ROADMAP Queue C)")
    wi, wo = params["wi"], params["wo"]
    d, f = wi.shape
    assert f % n_experts == 0, f"d_ff={f} not divisible by {n_experts} experts"
    fe = f // n_experts
    split = lambda w: w.view(d, n_experts, fe).permute(1, 0, 2)
    out = {"wi": split(wi), "wo": wo.view(n_experts, fe, wo.shape[1])}
    if "wg" in params:
        out["wg"] = split(params["wg"])
    return out


def unmoefy_mlp(params: dict) -> dict:
    """Inverse of ``moefy_mlp``; a view again for moefied views."""
    wi = params["wi"]
    e, d, fe = wi.shape
    merge = lambda w: w.permute(1, 0, 2).reshape(d, e * fe)
    out = {"wi": merge(wi), "wo": params["wo"].reshape(e * fe, -1)}
    if "wg" in params:
        out["wg"] = merge(params["wg"])
    return out
