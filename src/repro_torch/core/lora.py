"""LoRA adapters for the q/v projections (paper §5.1). B starts at zero, so
a fresh adapter is the identity."""
from __future__ import annotations

import torch


def lora_init(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              device=None) -> dict:
    a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32,
                    device=device) / d_in ** 0.5
    return {"a": a, "b": torch.zeros((rank, d_out), dtype=torch.float32,
                                     device=device)}


def lora_apply(lp, x, scale: float = 1.0):
    """Additive low-rank delta x @ A @ B * scale, computed in f32."""
    h = x.float() @ lp["a"] @ lp["b"]
    return (h * scale).to(x.dtype)
