"""RecurrentGemma / Griffin recurrent mixer with the RG-LRU. [arXiv:2402.19427]

    x -> (gate branch: W_y x -> GeLU) * (W_x x -> causal conv1d -> RG-LRU)
      -> W_out
    r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The counterpart of the JAX package's ``models/rglru.py``, which runs
outside Pallas, so it is plain PyTorch here too. The linear recurrence is a
log-depth Hillis-Steele scan over (a, b) pairs (JAX: ``associative_scan``,
whose tree differs, so the two agree to rounding, not bit for bit); decode
is the O(1) step form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of

_C = 8.0


def rglru_init(gen, cfg, device=None) -> dict:
    D, W, dt = cfg.d_model, cfg.lru_width, dtype_of(cfg)
    ck = cfg.conv_kernel
    f32 = torch.float32
    # Lambda so that a^c = sigmoid(Lambda)^c lies in [0.9, 0.999]
    u = 0.9 + 0.099 * torch.rand((W,), generator=gen, dtype=f32, device=device)
    uc = u ** (1.0 / _C)
    return {
        "w_y": dense_init(gen, D, W, dt, device=device),
        "w_x": dense_init(gen, D, W, dt, device=device),
        "conv_w": (torch.randn((ck, W), generator=gen, dtype=f32,
                               device=device) * 0.1).to(dt),
        "conv_b": torch.zeros((W,), dtype=dt, device=device),
        # the gates' weights stay f32 in a bf16 model, as in the JAX package
        "w_a": dense_init(gen, W, W, f32, device=device),
        "b_a": torch.zeros((W,), dtype=f32, device=device),
        "w_i": dense_init(gen, W, W, f32, device=device),
        "b_i": torch.zeros((W,), dtype=f32, device=device),
        "lam": torch.log(uc / (1.0 - uc)),
        "w_out": dense_init(gen, W, D, dt, device=device),
    }


def _gates(p, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(uf @ p["w_i"] + p["b_i"])
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated_in


def _causal_conv(x, w, b, state=None):
    ck, S = w.shape[0], x.shape[1]
    if state is not None:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xp = F.pad(x, (0, 0, ck - 1, 0))
    y = sum(xp[:, i:i + S] * w[i] for i in range(ck))
    return y + b, xp[:, -(ck - 1):]


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0), as a Hillis-Steele
    scan: log2(S) rounds of the (a, b) combine, no loop over S."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def rglru_apply(p, x, cfg, init_state=None, conv_state=None, keep_mask=None):
    """Full sequence. x: (B,S,D) -> (y (B,S,D), (h_final (B,W) f32, conv
    (B,ck-1,W))).

    keep_mask: (B,S) bool ElastiFormer token routing: a skipped token uses
    a = 1, input 0, an exact recurrent-state pass-through."""
    gate = _gelu((x @ p["w_y"]).float())
    u, new_conv = _causal_conv(x @ p["w_x"], p["conv_w"], p["conv_b"],
                               conv_state)
    a, b = _gates(p, u)                                      # (B,S,W) f32
    if keep_mask is not None:
        km = keep_mask[..., None]
        a = torch.where(km, a, torch.ones_like(a))
        b = torch.where(km, b, torch.zeros_like(b))
    if init_state is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * init_state.float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    y = (gate * h).to(x.dtype) @ p["w_out"]
    return y, (h[:, -1], new_conv)


def rglru_decode(p, x, cache, cfg, write=None):
    """One step. x: (B,1,D); cache: {'state': (B,W) f32, 'conv':
    (B,ck-1,W)}; ``write``: (B,) bool token gate (False: the caches pass
    through). Returns (y (B,1,D), {'state', 'conv'}: new tensors; the
    caller writes them into the cache)."""
    gate = _gelu((x @ p["w_y"]).float())
    xw = x @ p["w_x"]                                        # (B,1,W)
    conv_in = torch.cat([cache["conv"].to(xw.dtype), xw], dim=1)
    u = (torch.einsum("bkc,kc->bc", conv_in, p["conv_w"])
         + p["conv_b"])[:, None]
    a, b = _gates(p, u)                                      # (B,1,W)
    h = a[:, 0] * cache["state"] + b[:, 0]
    new_conv = conv_in[:, 1:]
    if write is not None:
        h = torch.where(write[:, None], h, cache["state"])
        new_conv = torch.where(write[:, None, None], new_conv, cache["conv"])
    y = (gate[:, 0] * h)[:, None].to(x.dtype) @ p["w_out"]
    return y, {"state": h, "conv": new_conv.to(cache["conv"].dtype)}


def rglru_cache_init(cfg, batch: int, device=None) -> dict:
    return {
        "state": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.lru_width),
                            dtype=dtype_of(cfg), device=device),
    }
