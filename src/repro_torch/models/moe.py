"""Mixture-of-experts MLP: native (qwen2-moe) and ElastiFormer's moefied
dense MLP share this machinery.

Dispatch is a per-expert capacity gather (exact top-k semantics, work in
proportion to the selected experts, no (B, S, E, C) one-hot): each expert
takes its top-C tokens by routing weight into a (B, E, C, D) buffer, the
grouped ``moe_gmm`` kernel runs every expert on its buffer (skipping the
slots past each expert's count), and every token gathers back its k expert
outputs. The JAX package's sequence-chunk ``lax.scan`` is a loop here.

Both top-k selections (the per-expert dispatch and the per-token combine)
are a STABLE descending sort sliced to k, so equal weights keep the lower
index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no tie
order on CUDA). At full expert budget every weight is exactly 1, so every
value ties there.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.routing import RouteAux, bcast_to, is_full, topk_mask, \
    topk_mask_dyn
from repro_torch.kernels import ops as OPS
from repro_torch.models import quant as Q
from repro_torch.models.layers import act_fn, dense_init, dtype_of, is_gated


def moe_init(gen, cfg, device=None) -> dict:
    """Native MoE params: router (D, E) f32, experts wi/wg (E, D, Fe) and
    wo (E, Fe, D) in the config dtype, and the optional shared path."""
    m = cfg.moe
    D, dt = cfg.d_model, dtype_of(cfg)
    E, Fe = m.n_experts, m.d_expert

    def stack(d_in, d_out):     # (d_in, E*d_out) -> contiguous (E, d_in, d_out)
        w = dense_init(gen, d_in, E * d_out, dt, device=device)
        return w.reshape(d_in, E, d_out).permute(1, 0, 2).contiguous()

    p = {"router": dense_init(gen, D, E, torch.float32, device=device),
         "wi": stack(D, Fe), "wo": stack(Fe, D)}
    if is_gated(cfg.act):
        p["wg"] = stack(D, Fe)
    if m.n_shared_experts:
        Fs = m.d_shared
        p["shared"] = {"wi": dense_init(gen, D, Fs, dt, device=device),
                       "wo": dense_init(gen, Fs, D, dt, device=device)}
        if is_gated(cfg.act):
            p["shared"]["wg"] = dense_init(gen, D, Fs, dt, device=device)
    return p


def _top(scores, k: int):
    """(values, indices) of the k largest entries along the last axis,
    descending, ties by ascending index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _expert_ffn(p, x_sel, act, backend=None, counts=None):
    """x_sel: (B, E, C, D) -> (B, E, C, D) through the ``moe_gmm`` kernel;
    ``counts`` (B, E) per-expert occupancy (the dispatch keeps the valid
    slots a prefix of each group, so the counts are exact). Engine-
    quantized stacks pass their per-(expert, channel) scales."""
    return OPS.moe_gmm(x_sel, p["wi"], p["wo"], p.get("wg"),
                       group_counts=counts, wi_scale=p.get("wi_scale"),
                       wo_scale=p.get("wo_scale"), wg_scale=p.get("wg_scale"),
                       act=act, backend=backend)


def moe_apply(p, x, *, act: str, top_k: int, router_w=None,
              normalize_to_m: bool = False, capacity_factor: float = 1.25,
              seq_chunk: int = 2048, top_k_traced=None, token_valid=None,
              dispatch_frac=None, token_count=None, backend=None):
    """x: (B, S, D) -> ((B, S, D), aux). ``router_w`` overrides
    ``p['router']`` (the elastic expert router).

    ``top_k_traced``: optional tensor expert count (() or (B,)). Buffers are
    then sized for ``top_k`` (the caller passes E) and experts ranked past
    the count are masked; a count >= E forces weight 1 on every expert (the
    exact dense module). ``token_valid`` (B, S) bars tokens from dispatch
    and from the load statistics; ``dispatch_frac`` (a token capacity)
    shrinks each expert's capacity to what a per-budget gather of that many
    tokens would have used; ``token_count`` (the ragged bucket's real
    prefix, an int or (B,)) derives ``dispatch_frac = count / S``. The
    capacity arithmetic runs in f32, as the JAX package's does: one ulp
    there decides whether a token is evicted from an expert."""
    B, S, D = x.shape
    dev = x.device
    if token_count is not None and dispatch_frac is None:
        if isinstance(token_count, (int, float)):
            dispatch_frac = float(token_count) / S
        else:
            dispatch_frac = torch.as_tensor(token_count, device=dev).to(
                torch.float32) / S
    rw = router_w if router_w is not None else p["router"]
    E = rw.shape[-1]
    k = min(top_k, E)
    chunk = min(seq_chunk, S)
    n_chunks = -(-S // chunk)
    # ragged S (an elastic token count) pads to a chunk multiple; padded
    # tokens are barred from dispatch
    s_pad = n_chunks * chunk
    x_orig = x
    tv = token_valid
    if s_pad != S:
        x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - S))
        if tv is not None:
            tv = torch.nn.functional.pad(tv.bool(), (0, s_pad - S))
    valid = torch.arange(s_pad, device=dev) < S
    cap = int(math.ceil(k * chunk / E * capacity_factor))
    cap = min(chunk, max(4, -(-cap // 4) * 4))
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)

    def one_chunk(xc, vc, tvc):
        s = xc.shape[1]
        logits = xc.float() @ rw                              # (B, s, E)
        probs = torch.softmax(logits, dim=-1)
        w = probs * E if normalize_to_m else probs
        cap_eff = None
        if dispatch_frac is None:
            kept = chunk
        elif torch.is_tensor(dispatch_frac):
            kept = torch.clamp(torch.ceil(
                dispatch_frac.float() * chunk - 1e-9), 1, chunk)
        else:   # a Python fraction: the sum in f64, then f32 (as in JAX)
            kept = torch.clamp(torch.ceil(f32(dispatch_frac * chunk - 1e-9)),
                               1, chunk)
        if top_k_traced is None:
            mask = topk_mask(w, k) & vc[None, :, None]
            k_for_cap = k
        else:
            kt = torch.clamp(top_k_traced, 1, E)
            full = bcast_to(is_full(top_k_traced, E), w.dim())
            w = torch.where(full, torch.ones_like(w), w)
            mask = topk_mask_dyn(w, kt) & vc[None, :, None]
            k_for_cap = kt
        if tvc is not None:
            mask = mask & tvc[:, :, None]
        if top_k_traced is not None or dispatch_frac is not None:
            # the per-expert capacity the per-budget path would have used
            # (buffers stay sized for the static maximum ``cap``)
            ce = torch.ceil(f32(k_for_cap * kept) / E * capacity_factor)
            cap_eff = torch.minimum(
                f32(kept), torch.clamp(torch.ceil(ce / 4) * 4, min=4))
        # load-balance statistics over REAL tokens only
        stat_w = vc[None, :, None].float().expand(B, s, 1)
        if tvc is not None:
            stat_w = stat_w * tvc[:, :, None].float()
        denom = torch.clamp(stat_w.sum(), min=1.0)
        red_frac = (mask * stat_w).sum(dim=(0, 1)) / denom
        load = E * torch.sum(red_frac * (probs * stat_w).sum(dim=(0, 1))
                             / denom)
        sc = torch.where(mask, w, torch.full_like(w, -math.inf))  # (B, s, E)
        vals, idx = _top(sc.transpose(1, 2), cap)             # (B, E, C)
        keep = torch.isfinite(vals)
        if cap_eff is not None:
            keep = keep & (torch.arange(cap, device=dev)[None, None, :]
                           < bcast_to(cap_eff, 3))
        # dispatch: token gather into (B, E, C, D) buffers (unweighted)
        x_sel = torch.gather(
            xc[:, None].expand(B, E, s, D), 2,
            idx[..., None].expand(B, E, cap, D))
        # top-k is descending, so the kept slots are a prefix of each group:
        # their number is the exact group count the kernel skips by
        y_buf = _expert_ffn(p, x_sel, act, backend=backend,
                            counts=keep.sum(-1))              # (B, E, C, D)
        # combine by GATHER through the inverted dispatch index: each token
        # reads back its k expert outputs and sums them in one fixed order
        slot_of = torch.full((B, E, s), -1, dtype=torch.int64, device=dev)
        ar = torch.arange(cap, device=dev).expand(B, E, cap)
        slot_of.scatter_(2, idx, torch.where(keep, ar, torch.full_like(ar, -1)))
        wtok, eids = _top(sc, k)                              # (B, s, k)
        slots = torch.gather(slot_of.transpose(1, 2), 2, eids)
        ok = torch.isfinite(wtok) & (slots >= 0)
        lin = eids * cap + torch.clamp(slots, min=0)          # (B, s, k)
        y_tok = torch.gather(
            y_buf.reshape(B, E * cap, D), 1,
            lin.reshape(B, s * k, 1).expand(B, s * k, D)).reshape(B, s, k, D)
        wt = torch.where(ok, wtok, torch.zeros_like(wtok))
        out = torch.sum(y_tok * wt[..., None].to(xc.dtype), dim=2)
        return out.to(xc.dtype), load

    ys, loads = [], []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, load = one_chunk(x[:, sl], valid[sl],
                            None if tv is None else tv[:, sl].bool())
        ys.append(y)
        loads.append(load)
    y = torch.cat(ys, dim=1)[:, :S]
    if "shared" in p:
        y = y + _dense_ffn(p["shared"], x_orig, act)
    return y, RouteAux.of(load=torch.stack(loads).mean())


def _dense_ffn(p, x, act):
    """The shared expert path: a plain dense MLP in x's dtype (quantized
    weights widened, the products' channels scaled: ``models/quant.py``)."""
    w = lambda name: Q.widened(p, name, x.dtype)
    h = Q.scaled(x @ w("wi"), p, "wi")
    if "wg" in p:
        h = act_fn(act)(Q.scaled(x @ w("wg"), p, "wg")) * h
    else:
        h = act_fn(act)(h)
    return Q.scaled(h @ w("wo"), p, "wo").to(x.dtype)


def moe_decode(p, x, *, act: str, top_k: int, router_w=None,
               normalize_to_m: bool = False, top_k_traced=None):
    """Decode path (S == 1): y[b] = sum over the k selected experts of
    weight * FFN_e(x[b]). With ``top_k_traced`` experts ranked past the
    count get weight 0 (>= E: every expert weight 1, the dense module).

    The JAX package gathers the selected experts' weights, (B, k, D, Fe),
    every step. In eager PyTorch that gather is a copy (with a tensor top-k
    the selection is every expert of every slot). So this runs every
    expert once on the whole slot array and combines in f32 with a (B, E)
    weight matrix that is zero off the selection: each expert's weights are
    read once, in place, whatever the views' strides."""
    B, S, D = x.shape
    rw = router_w if router_w is not None else p["router"]
    E = rw.shape[-1]
    k = min(top_k, E)
    logits = x.float() @ rw                                   # (B, 1, E)
    probs = torch.softmax(logits, dim=-1)
    w = probs * E if normalize_to_m else probs
    vals, idx = _top(w[:, 0], k)                              # (B, k)
    if top_k_traced is not None:
        kt = torch.clamp(top_k_traced, 1, E)
        sel = torch.arange(k, device=x.device)[None, :] < bcast_to(kt, 2)
        full = bcast_to(is_full(top_k_traced, E), 2)
        vals = torch.where(full, torch.ones_like(vals),
                           torch.where(sel, vals, torch.zeros_like(vals)))
    xt = x[:, 0]                                              # (B, D)
    we = torch.zeros((B, E), dtype=vals.dtype, device=x.device)
    we = we.scatter(1, idx, vals)
    # engine-quantized stacks: codes widened, (E, 1, channel) scales
    mm = lambda a, name: Q.scaled(
        torch.matmul(a, Q.widened(p, name, x.dtype)), p, name,
        (E, 1, p[name].shape[-1]))
    h = mm(xt, "wi")                                          # (E, B, Fe)
    if "wg" in p:
        h = act_fn(act)(mm(xt, "wg")) * h
    else:
        h = act_fn(act)(h)
    y = torch.einsum("ebd,be->bd", mm(h, "wo").float(), we)
    y = y[:, None].to(x.dtype)
    if "shared" in p:
        y = y + _dense_ffn(p["shared"], x, act)
    return y, RouteAux.zero(x.device)
