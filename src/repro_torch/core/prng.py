"""The threefry2x32 counter-based PRNG, laid out as ``jax.random``'s
default implementation lays it out (``jax_threefry_partitionable=True``),
so a seed gives the JAX package's sample stream bit for bit.

Keys are ``(..., 2)`` int64 tensors holding uint32 words. Torch has no
addition or shifts for ``torch.uint32``, so the rounds run in int64 and
mask each result to 32 bits. Everything is elementwise: the same code runs
on CPU and CUDA tensors, batched over leading key dimensions.

    key = fold_in(PRNGKey(seeds), positions)       # (B, 2)
    g = gumbel(key, V)                             # (B, V) float32
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or Python int as int64 holding its low 32 bits."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds over uint32 words held in int64
    tensors (broadcast together). Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: the key words (0, seed).
    ``seed``: an int or an integer tensor of any shape -> (..., 2)."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the 32-bit ``data``
    (broadcast against the key's leading dimensions)."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under the partitionable
    layout: word i is the XOR of threefry(key, (0, i))'s two outputs.
    ``key`` (..., 2) -> (..., n) int64 holding uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds as f32 scalars, not device tensors: no host-to-device copy
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(f * float(hi - lo) + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)``: -log(-log(u)) over
    uniforms in [tiny, 1). Agrees with JAX to within the ulp of the two
    logarithms."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, minval=tiny)))
