"""Shared neural-net primitives: norms, activations, inits, RoPE, dense MLP.

Params are plain dicts of tensors. Inits draw from an explicit
``torch.Generator`` and return tensors in the config dtype (norms and
routers in f32), with the JAX package's scales (its random numbers differ).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import gelu_tanh
from repro_torch.models import quant as Q

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, device=None) -> torch.Tensor:
    """N(0, 1) * (1/sqrt(d_in) unless ``scale``), drawn in f32, then cast."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def norm_init(d: int, kind: str, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def act_fn(name: str):
    """silu for swiglu; the tanh-approximate GELU otherwise (JAX default)."""
    return F.silu if name == "swiglu" else gelu_tanh


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def rope_tables(positions, d_head: int, theta: float):
    """f32 cos/sin tables (..., d_head/2) for integer positions (...,)."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """Half-split RoPE. x: (..., n_heads, d_head); cos/sin: (..., d_head/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mlp_init(gen, cfg, device=None) -> dict:
    D, Fd, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    p = {"wi": dense_init(gen, D, Fd, dt, device=device),
         "wo": dense_init(gen, Fd, D, dt, device=device)}
    if is_gated(cfg.act):
        p["wg"] = dense_init(gen, D, Fd, dt, device=device)
    return p


def mlp_apply(p, x, act: str):
    """Plain dense MLP in x's dtype (the decode path; prefill runs the
    fused_mlp kernel). Engine-quantized weights: int8 codes widened to x's
    dtype, the products' output channels scaled (``models/quant.py``)."""
    w = lambda name: Q.widened(p, name, x.dtype)
    h = Q.scaled(x @ w("wi"), p, "wi")
    if is_gated(act):
        h = act_fn(act)(Q.scaled(x @ w("wg"), p, "wg")) * h
    else:
        h = act_fn(act)(h)
    return Q.scaled(h @ w("wo"), p, "wo").to(x.dtype)
