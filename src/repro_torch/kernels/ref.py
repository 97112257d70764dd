"""Plain PyTorch versions of the port's kernels.

Each has the contract of its oracle in the JAX package's ``kernels/ref.py``.
The CPU path and the tests run them; on the card ``chip_smoke.py`` holds
each hand-written kernel against them, and the kernels' backward passes
replay them (``kernels/ops.py``). They compute in f32 (f64 inputs stay f64,
for ``gradcheck``). An int8 weight, K or V operand comes with its f32
scales (per output channel; per (token, kv-head) for K/V) and is
dequantized as ``q.float() * scale``, the JAX oracles' expression.

One deliberate difference: a flash-attention query row with NO attendable
key is undefined in the JAX oracle (uniform softmax over every key) and in
the Pallas kernel (uniform over the blocks it visits). Here, as in the CUDA
kernel, such rows are exact zeros — the decode oracle's rule. On the serving
path those rows belong to tokens the router dropped, whose output the block
multiplies by a token weight of 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _f(t):
    """The compute type: f32, or f64 for f64 inputs."""
    return t if t.dtype == torch.float64 else t.float()


def _dq_kv(x, scale):
    """int8 K/V + per-(token, head) scale -> f32 (x itself without one)."""
    return x if scale is None else x.float() * scale.float()[..., None]


def _dq_w(w, scale):
    """int8 weight + per-output-channel scale -> f32: the scale spans the
    last axis ((F,) / (D,) dense, (E, F) / (E, D) expert stacks)."""
    return w if scale is None else w.float() * scale.float()[..., None, :]


def _counts(count, batch: int, limit: int, device) -> torch.Tensor:
    """None | int | () / (B,) tensor -> (B,) int64 clipped to [0, limit]."""
    if count is None:
        return torch.full((batch,), limit, dtype=torch.int64, device=device)
    c = torch.as_tensor(count, device=device).to(torch.int64).reshape(-1)
    return c.expand(batch).clamp(0, limit)


def flash_attention_ref(q, k, v, *, causal=True, window=0, kv_valid=None,
                        sm_scale=None, kv_count=None):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,K,Dh) -> (B,Sq,H,Dh). Masks by array
    index; kv_valid (B,Sk) bool; kv_count: None, scalar or (B,) count of
    real leading q/kv rows (rows past it are zeros)."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    sm_scale = Dh ** -0.5 if sm_scale is None else sm_scale
    qg = _f(q.reshape(B, Sq, K, G, Dh))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, _f(k)) * sm_scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window and window > 0:
        mask = mask & ((qpos - kpos) < window)
    mask = mask.expand(B, 1, 1, Sq, Sk)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, None, :]
    cnt = _counts(kv_count, B, max(Sq, Sk), q.device)
    mask = mask & (kpos < cnt[:, None, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", a, _f(v))
    ctx = ctx.reshape(B, Sq, H, Dh)
    any_key = mask.any(-1).expand(B, K, G, Sq)
    any_key = any_key.permute(0, 3, 1, 2).reshape(B, Sq, H)
    live = any_key & (torch.arange(Sq, device=q.device)[None, :, None]
                      < cnt[:, None, None])
    ctx = torch.where(live[..., None], ctx, torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def decode_attention_ref(q, k, v, kv_pos, t, *, window=0, kv_valid=None,
                         kscale=None, vscale=None, sm_scale=None):
    """Ring-cache decode attention. q: (B,1,H,Dh); k,v: (B,L,K,Dh);
    kv_pos: (B,L) absolute positions (-1 = empty); t: (B,) per-slot decode
    positions; kscale/vscale: (B,L,K) f32 scales of int8 k/v. Masks by the
    cache's position array, not by slot index; rows with no attendable key
    are exact zeros."""
    k, v = _dq_kv(k, kscale), _dq_kv(v, vscale)
    B, Sq, H, Dh = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    sm_scale = Dh ** -0.5 if sm_scale is None else sm_scale
    t = torch.as_tensor(t, device=q.device).to(torch.int64).reshape(-1)
    t = t.expand(B)
    qg = q.reshape(B, Sq, K, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * sm_scale
    pos = kv_pos.to(torch.int64)
    mask = (pos >= 0) & (pos <= t[:, None])
    if window and window > 0:
        mask = mask & ((t[:, None] - pos) < window)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    # masked rows of v are zeroed before the product (0 * NaN guard)
    vz = torch.where(mask[:, :, None, None], v.float(),
                     torch.zeros((), device=v.device))
    ctx = torch.einsum("bkgqs,bskd->bqkgd", a, vz)
    ctx = ctx.reshape(B, Sq, H, Dh)
    ctx = torch.where(mask.any(-1)[:, None, None, None], ctx,
                      torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def paged_decode_attention_ref(q, kp, vp, table, t, pvalid, *, kscale=None,
                               vscale=None, sm_scale=None):
    """Paged-pool decode attention. q: (B,1,H,Dh); kp, vp: (N, ps, K, Dh)
    global page pool; table: (B, P) int page-table rows (-1 = unused); t:
    (B,) per-slot decode positions; pvalid: (N, ps) bool routing validity.
    Gathers each slot's pages in table order (key j of slot b at page
    ``table[b, j // ps]``, lane ``j % ps``) and masks by the implicit
    position j: attendable iff the entry is >= 0, j <= t[b] and the lane
    is valid; kscale/vscale: (N, ps, K) f32 scale pools of int8 kp/vp.
    Rows with no attendable key are exact zeros."""
    kp, vp = _dq_kv(kp, kscale), _dq_kv(vp, vscale)
    B, Sq, H, Dh = q.shape
    ps, K = kp.shape[1], kp.shape[2]
    P = table.shape[1]
    G = H // K
    sm_scale = Dh ** -0.5 if sm_scale is None else sm_scale
    table = torch.as_tensor(table, device=q.device).to(torch.int64)
    t = torch.as_tensor(t, device=q.device).to(torch.int64).reshape(-1)
    t = t.expand(B)
    pid = table.clamp(min=0)                                  # (B, P)
    k = kp[pid].reshape(B, P * ps, K, Dh).float()             # gather pages
    v = vp[pid].reshape(B, P * ps, K, Dh).float()
    pos = torch.arange(P * ps, device=q.device)               # implicit
    mask = ((table[:, :, None] >= 0) & pvalid.bool()[pid]).reshape(B, P * ps)
    mask = mask & (pos[None, :] <= t[:, None])
    qg = q.reshape(B, Sq, K, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * sm_scale
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    # masked rows of v are zeroed before the product (0 * NaN guard)
    vz = torch.where(mask[:, :, None, None], v,
                     torch.zeros((), device=v.device))
    ctx = torch.einsum("bkgqs,bskd->bqkgd", a, vz)
    ctx = ctx.reshape(B, Sq, H, Dh)
    ctx = torch.where(mask.any(-1)[:, None, None, None], ctx,
                      torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def gelu_tanh(x):
    """The tanh-approximate GELU (the JAX default, not torch's exact one)."""
    return F.gelu(x, approximate="tanh")


def _act(name):
    return F.silu if name == "swiglu" else gelu_tanh


def fused_mlp_ref(x, wi, wo, wg=None, token_weights=None, *, act="swiglu",
                  valid_count=None, wi_scale=None, wo_scale=None,
                  wg_scale=None):
    """y = w * (act(x Wg) * (x Wi)) Wo in f32. x: (T, D) or (B, T, D);
    valid_count: None | scalar | (B,) count of real leading rows (rows past
    it are zeros); wi_scale/wg_scale (F,) and wo_scale (D,): the scales of
    int8 weights."""
    wi, wo = _dq_w(wi, wi_scale), _dq_w(wo, wo_scale)
    wg = _dq_w(wg, wg_scale) if wg is not None else None
    xf = _f(x)
    h = xf @ _f(wi)
    if wg is not None:
        h = _act(act)(xf @ _f(wg)) * h
    else:
        h = gelu_tanh(h) if act == "gelu" else F.silu(h)
    y = h @ _f(wo)
    if token_weights is not None:
        y = y * _f(token_weights)[..., None]
    if valid_count is not None:
        rows = torch.arange(x.shape[-2], device=x.device)
        if x.dim() == 3:
            cnt = _counts(valid_count, x.shape[0], x.shape[-2], x.device)
            y = torch.where(rows[None, :, None] < cnt[:, None, None], y,
                            torch.zeros((), device=x.device))
        else:
            cnt = torch.as_tensor(valid_count, device=x.device)
            y = torch.where(rows[:, None] < cnt, y,
                            torch.zeros((), device=x.device))
    return y.to(x.dtype)


def fused_mlp_routed_ref(x, idx, wi, wo, wg=None, token_weights=None, *,
                         act="swiglu", valid_count=None, wi_scale=None,
                         wo_scale=None, wg_scale=None):
    """Gather / MLP / scatter: x (B, S, D), idx (B, Kb) gather indices (no
    duplicates in a row), token_weights (B, Kb), valid_count None | scalar
    | (B,). Returns the (B, S, D) delta: row idx[b, i] with i < count[b]
    gets tw[b, i] * MLP(x[b, idx[b, i]]), every other row is zero."""
    ix = idx.long()[..., None].expand(idx.shape + (x.shape[-1],))
    y = fused_mlp_ref(torch.gather(x, 1, ix), wi, wo, wg, token_weights,
                      act=act, valid_count=valid_count, wi_scale=wi_scale,
                      wo_scale=wo_scale, wg_scale=wg_scale)
    return torch.zeros_like(x).scatter(1, ix, y)


def moe_gmm_ref(x, wi, wo, wg=None, weights=None, *, act="swiglu",
                group_counts=None, wi_scale=None, wo_scale=None,
                wg_scale=None):
    """Grouped expert MLP: y[b,e,c] = w[b,e,c] * (act(x Wg[e]) * (x Wi[e]))
    Wo[e] in f32. x: (E, C, D) or (B, E, C, D); wi/wg: (E, D, Fe); wo:
    (E, Fe, D); weights: (E, C) / (B, E, C); group_counts: (E,) / (B, E)
    count of real leading slots per group (slots at or past it are exact
    zeros); wi_scale/wg_scale (E, Fe) and wo_scale (E, D): the scales of
    int8 expert stacks. Returns x's shape and dtype."""
    wi, wo = _dq_w(wi, wi_scale), _dq_w(wo, wo_scale)
    wg = _dq_w(wg, wg_scale) if wg is not None else None
    xf = _f(x)
    h = torch.einsum("...ecd,edf->...ecf", xf, _f(wi))
    if wg is not None:
        h = _act(act)(torch.einsum("...ecd,edf->...ecf", xf, _f(wg))) * h
    else:
        h = gelu_tanh(h) if act == "gelu" else F.silu(h)
    y = torch.einsum("...ecf,efd->...ecd", h, _f(wo))
    if weights is not None:
        y = y * _f(weights)[..., None]
    if group_counts is not None:
        cnt = torch.as_tensor(group_counts, device=x.device).to(torch.int64)
        slots = torch.arange(x.shape[-2], device=x.device)
        y = torch.where(slots[:, None] < cnt[..., None, None], y,
                        torch.zeros((), dtype=y.dtype, device=x.device))
    return y.to(x.dtype)
