"""Mamba2 SSD (state-space duality) mixer: the chunked form for training and
prefill, the O(1)-state recurrent form for decode. [arXiv:2405.21060]

The counterpart of the JAX package's ``models/ssm.py``, which runs outside
Pallas (jnp einsums and a ``lax.scan`` over chunk states), so it is plain
PyTorch here too: the chunk einsums in f32 and a loop over the chunks, the
only sequential part, in the scan's order. The projections stay separate
parameters (z, x, B, C, dt), with the JAX package's names and layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of, norm_apply


def ssm_init(gen, cfg, device=None) -> dict:
    D, dt = cfg.d_model, dtype_of(cfg)
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    ck = cfg.conv_kernel
    f32 = torch.float32

    def conv(c):
        return (torch.randn((ck, c), generator=gen, dtype=f32, device=device)
                * 0.1).to(dt)

    return {
        "in_z": dense_init(gen, D, di, dt, device=device),
        "in_x": dense_init(gen, D, di, dt, device=device),
        "in_b": dense_init(gen, D, N, dt, device=device),
        "in_c": dense_init(gen, D, N, dt, device=device),
        "in_dt": dense_init(gen, D, H, dt, device=device),
        "conv_x": conv(di), "conv_b": conv(N), "conv_c": conv(N),
        "conv_bias_x": torch.zeros((di,), dtype=dt, device=device),
        "conv_bias_b": torch.zeros((N,), dtype=dt, device=device),
        "conv_bias_c": torch.zeros((N,), dtype=dt, device=device),
        "a_log": torch.zeros((H,), dtype=f32, device=device),  # A = -1
        "d_skip": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "norm_scale": torch.ones((di,), dtype=f32, device=device),
        "out_proj": dense_init(gen, di, D, dt, device=device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x: (B,S,C), w: (ck,C) -> (B,S,C)."""
    ck, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, ck - 1, 0))
    y = sum(xp[:, i:i + S] * w[i] for i in range(ck))
    return y + b


def _segsum(a):
    """a: (..., q) -> (..., q, q) with out[i,j] = sum_{j<m<=i} a[m], -inf
    above the diagonal (strictly causal cumulative decay)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~tri, float("-inf"))


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int, init_state=None):
    """SSD: y_t = C_t^T h_t,  h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T.

    x: (B,S,H,P); dt: (B,S,H); a: (H,) (negative); bmat/cmat: (B,S,N).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} % ssm_chunk {chunk} != 0")
    nc, q = S // chunk, chunk
    f32 = torch.float32
    dA = (dt * a).to(f32)                                    # (B,S,H)
    xdt = (x * dt[..., None]).to(f32)

    def r(t):
        return t.reshape((B, nc, q) + tuple(t.shape[2:]))

    xc, dAc = r(xdt), r(dA)
    bc, cc = r(bmat.to(f32)), r(cmat.to(f32))

    # intra-chunk (quadratic within a chunk)
    L = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))          # (B,nc,H,q,q)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)             # (B,nc,q,q)
    y_diag = torch.einsum("bcqk,bchqk,bckhp->bcqhp", cb, L, xc)

    # chunk states
    dA_cum = torch.cumsum(dAc, dim=2)                        # (B,nc,q,H)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,q,H)
    states = torch.einsum("bckn,bckh,bckhp->bchpn", bc, decay_states, xc)

    # inter-chunk recurrence (the only sequential part), in the scan's order
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])             # (B,nc,H)
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                     # before chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,H,P,N)

    state_decay = torch.exp(dA_cum)                          # (B,nc,q,H)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, h_prev, state_decay)
    return (y_diag + y_off).reshape(B, S, H, P), h


def _project(p, x):
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_b"], x @ p["in_c"],
            x @ p["in_dt"])


def _conv_params(p):
    w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    b = torch.cat([p["conv_bias_x"], p["conv_bias_b"], p["conv_bias_c"]],
                  dim=-1)
    return w, b


def _out(p, y, z, x):
    """Gated RMSNorm and the output projection."""
    y = norm_apply({"scale": p["norm_scale"]},
                   (y * F.silu(z.float())).to(x.dtype), "rmsnorm")
    return y @ p["out_proj"]


def chunk_for(s: int, ssm_chunk: int) -> int:
    """The largest divisor of ``s`` not exceeding ``ssm_chunk`` (a prime
    length gets chunk 1), as the JAX package picks it."""
    chunk = min(ssm_chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def ssm_apply(p, x, cfg, init_state=None, conv_state=None, keep_mask=None):
    """Full-sequence Mamba2 mixer. x: (B,S,D) -> (y (B,S,D), (ssm_state
    (B,H,P,N) f32, conv_state (B,ck-1,di+2N))) for the cache at prefill.

    keep_mask: (B,S) bool ElastiFormer token routing: dt is zeroed for a
    skipped token, which makes the recurrence an exact state pass-through
    (decay exp(a*0) = 1, input dt*B*x = 0)."""
    B, S, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P, ck = cfg.ssm_head_dim, cfg.conv_kernel
    z, xs, bmat, cmat, dt = _project(p, x)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    conv_w, conv_b = _conv_params(p)
    if conv_state is not None:
        xbc_in = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        xbc_conv = _causal_conv(xbc_in, conv_w, conv_b)[:, -S:]
    else:
        xbc_in = xbc
        xbc_conv = _causal_conv(xbc, conv_w, conv_b)
    new_conv = xbc_in[:, -(ck - 1):]
    xbc_conv = F.silu(xbc_conv)
    xs, bmat, cmat = torch.split(xbc_conv, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if keep_mask is not None:
        dt = dt * keep_mask[..., None].to(dt.dtype)
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, a, bmat, cmat, chunk_for(S, cfg.ssm_chunk),
                           init_state)
    y = y + p["d_skip"][:, None] * xh.float()
    return _out(p, y.reshape(B, S, di), z, x), (state, new_conv)


def ssm_decode(p, x, cache, cfg, write=None):
    """One decode step. x: (B,1,D); cache: {'state': (B,H,P,N) f32,
    'conv': (B,ck-1,di+2N)}. ``write``: (B,) bool token gate; where False
    the state and conv caches pass through unchanged (token skipped).
    Returns (y (B,1,D), {'state', 'conv'}: new tensors; the caller writes
    them into the cache)."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z, xs, bmat, cmat, dt = _project(p, x)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)                 # (B,1,C)
    conv_w, conv_b = _conv_params(p)
    conv_in = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    y_conv = torch.einsum("bkc,kc->bc", conv_in, conv_w) + conv_b
    xs, bmat, cmat = torch.split(F.silu(y_conv)[:, None], [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]          # (B,H)
    dA = torch.exp(dt * -torch.exp(p["a_log"]))               # (B,H)
    xh = xs.reshape(B, H, P).float()
    new_state = (cache["state"] * dA[..., None, None]
                 + torch.einsum("bh,bhp,bn->bhpn", dt, xh,
                                bmat[:, 0].float()))
    if write is not None:
        new_state = torch.where(write[:, None, None, None], new_state,
                                cache["state"])
        new_conv = torch.where(write[:, None, None], conv_in[:, 1:],
                               cache["conv"])
    else:
        new_conv = conv_in[:, 1:]
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), new_state)
    y = y + p["d_skip"][:, None] * xh
    return (_out(p, y.reshape(B, 1, di), z, x),
            {"state": new_state, "conv": new_conv.to(cache["conv"].dtype)})


def ssm_cache_init(cfg, batch: int, device=None) -> dict:
    di, N = cfg.d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * N),
                            dtype=dtype_of(cfg), device=device),
    }
