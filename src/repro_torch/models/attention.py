"""Grouped-query self-attention with RoPE, sliding windows, ring and paged
KV caches, and the ElastiFormer hooks (head-routing weights, LoRA on q/v).

Prefill runs the flash-attention kernel, ring decode the ring-cache decode
kernel, and paged decode and paged prefill chunks the paged decode kernel
(``kernels/ops.py``: the CUDA kernels on the card, their plain versions on
the CPU). Both keep f32 probabilities where the JAX package's
``sdpa`` twin casts them to v's dtype; the port follows the kernels.

Tensor parallelism (``with mesh:``, ``runtime/mesh.py``): each rank holds
q-heads ``[r*Hp/M, (r+1)*Hp/M)`` and kv-heads ``[r*K/M, ...)`` of the
projections and of its ring cache or page pool, runs the kernels on them
(per-head work needs no collective: the counterpart of the JAX package's
``decode_attention_sharded``), and ``all_reduce_sum`` completes the
``wo`` projection's partial sum. On a data axis the rank holds its
replica's slots and its replica's pages of the pool: the page table and
the trash pages carry global ids, which the paged paths rebase by the
replica's page offset (``ops.paged_decode_attention_sharded``, the JAX
package's shard body) for the write and the read. The LoRA q delta and the head-routing
weights are computed whole and sliced to the rank's heads.

Padded q-heads (``cfg.n_heads_p != cfg.n_heads``, the JAX package's
``head_pad``): ``wq``/``bq``/``wo`` carry ``Hp`` heads, the pad heads'
weights zero, and each q-head ``h`` reads kv-head ``min(h // (H / K),
K - 1)``, the JAX package's repeat-kv map (``_expand_kv``). That map does
not fit the kernels' head -> kv-group map, so a padded config takes the
kernels' plain versions on k/v expanded to the q-heads (all-gathered over
the ``model`` axis first under a mesh), as the JAX package takes its jnp
path (``_kernel_ok``); on a CUDA tensor it raises.

One call the kernels do not take, in either package: a sliding window over
a gathered RoutingPlan buffer. The kernels mask the window by array index,
which equals the position distance only on position-contiguous rows, so
the JAX package computes that case outside its kernels (``_mask`` +
``sdpa``, by position); the port does the same in
``windowed_gathered_attention``.

Quantized serving (``kv_dtype``, ``weight_dtype``; ``models/quant.py``):
the projections read engine-quantized weights through ``quant.widened`` /
``quant.scaled``; an int8 cache carries ``kscale``/``vscale`` beside its
codes, and K/V are quantized ONCE, at each write site (ring decode, paged
decode, the paged chunk; the ring prefill in ``blocks._pad_cache``). A
token the gate skipped keeps its old codes and scales. The decode kernels
read the stored codes with their scales; no cache is ever widened.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lora import lora_apply
from repro_torch.kernels import ops as OPS
from repro_torch.models import quant as Q
from repro_torch.models.layers import dense_init, dtype_of, rope_apply, rope_tables
from repro_torch.runtime import collectives as C

NEG_INF = -1e30     # the masked score of windowed_gathered_attention


def padded(cfg) -> bool:
    return cfg.n_heads_p != cfg.n_heads


def check_kernel_ok(cfg, t: Optional[torch.Tensor] = None) -> None:
    """Refuse what the attention kernels cannot serve: padded q-heads on a
    CUDA tensor (their head -> kv-group map does not fit uneven padding;
    the CPU runs the plain versions on expanded k/v), and under a mesh a
    head count that does not divide the ``model`` axis."""
    if padded(cfg) and t is not None and t.is_cuda:
        raise NotImplementedError(
            f"head_pad={cfg.head_pad} pads {cfg.n_heads} q-heads to "
            f"{cfg.n_heads_p}: padded q-heads on the attention kernels arrive "
            f"with ROADMAP Queue A item 11 (part 7, padded heads on the "
            f"kernels)")
    _, m = C.tp_rank_size()
    if m > 1 and (cfg.n_heads_p % m or cfg.n_kv_heads % m):
        raise NotImplementedError(
            f"{cfg.n_heads_p} q-heads and {cfg.n_kv_heads} kv-heads over a "
            f"model axis of {m}: heads that do not divide it arrive with "
            f"ROADMAP Queue A item 11 (part 7, padded heads on the kernels)")


def _pad_heads(t, cfg, axis: int):
    """A head-indexed tensor padded with zeros from H to Hp on ``axis``."""
    H, Hp = cfg.n_heads, cfg.n_heads_p
    if Hp == H:
        return t
    shape = list(t.shape)
    shape[axis] = Hp - H
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def _rank_heads(cfg) -> tuple:
    """(first q-head, q-heads) of this rank: all ``Hp`` off a mesh."""
    r, m = C.tp_rank_size()
    hl = cfg.n_heads_p // m
    return r * hl, hl


def _local_heads(t, cfg, axis: int):
    """A whole (H-head) tensor padded to Hp and sliced to the rank's
    q-heads on ``axis``."""
    t = _pad_heads(t, cfg, axis)
    r0, hl = _rank_heads(cfg)
    return t if hl == t.shape[axis] else t.narrow(axis, r0, hl)


def _expand_kv(t, cfg, axis: int = 2):
    """Padded heads: the rank's kv-heads (``axis``) all-gathered over the
    ``model`` axis and expanded to its q-heads by the JAX package's
    repeat-kv map, q-head h -> kv-head min(h // (H / K), K - 1). Without
    padding ``t`` itself (the kernels map the groups)."""
    if not padded(cfg):
        return t
    check_kernel_ok(cfg, t)
    full = C.all_gather(t, dim=axis)
    K = full.shape[axis]
    g = max(1, cfg.n_heads // K)
    r0, hl = _rank_heads(cfg)
    idx = torch.clamp(torch.arange(r0, r0 + hl, device=t.device) // g,
                      max=K - 1)
    return full.index_select(axis, idx)


def attn_init(gen, cfg, device=None) -> dict:
    """The projections; padded q-heads as the JAX package pads them:
    ``wq``'s and ``wo``'s pad heads zero, ``bq`` (Hp, Dh)."""
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = dtype_of(cfg)
    p = {
        "wq": _pad_heads(dense_init(gen, D, H * Dh, dt,
                                    device=device).reshape(D, H, Dh),
                         cfg, 1),
        "wk": dense_init(gen, D, K * Dh, dt, device=device).reshape(D, K, Dh),
        "wv": dense_init(gen, D, K * Dh, dt, device=device).reshape(D, K, Dh),
        "wo": _pad_heads(dense_init(gen, H * Dh, D, dt,
                                    device=device).reshape(H, Dh, D),
                         cfg, 0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads_p, Dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, Dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, Dh), dtype=dt, device=device)
    return p


def _lora_scale(lora, d: int):
    """Optional tensor on/off multiplier ((), or (B,)) set by the policy:
    0 disables the adapter (full-budget / teacher rows stay lossless)."""
    s = lora.get("scale")
    return None if s is None else s.reshape(tuple(s.shape) + (1,) * (d - s.dim()))


def _rope(positions, cfg):
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    if cos.dim() == 2:               # (S, half) -> broadcast over batch
        cos, sin = cos[None], sin[None]
    return cos, sin


def _proj(p, name, x):
    """x (B,S,D) times the (D, heads, Dh) projection ``name``."""
    return Q.scaled(torch.einsum("bsd,dhk->bshk", x,
                                 Q.widened(p, name, x.dtype)), p, name)


def _project_q(p, x, positions, cfg, lora, use_rope: bool = True):
    check_kernel_ok(cfg)
    q = _proj(p, "wq", x)
    if lora is not None and "q" in lora:
        dq = lora_apply(lora["q"], x).reshape(
            x.shape[0], x.shape[1], cfg.n_heads, cfg.d_head)
        s = _lora_scale(lora, dq.dim())
        if s is not None:
            dq = dq * s.to(dq.dtype)
        q = q + _local_heads(dq, cfg, 2)
    if "bq" in p:
        q = q + p["bq"]
    return rope_apply(q, *_rope(positions, cfg)) if use_rope else q


def _project_kv(p, x, positions, cfg, lora, use_rope: bool = True):
    k = _proj(p, "wk", x)
    v = _proj(p, "wv", x)
    if lora is not None and "v" in lora:
        dv = lora_apply(lora["v"], x).reshape(
            x.shape[0], x.shape[1], cfg.n_kv_heads, cfg.d_head)
        s = _lora_scale(lora, dv.dim())
        if s is not None:
            dv = dv * s.to(dv.dtype)
        r, m = C.tp_rank_size()
        kl = cfg.n_kv_heads // m
        v = v + (dv if m == 1 else dv.narrow(2, r * kl, kl))
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if not use_rope:
        return k, v
    return rope_apply(k, *_rope(positions, cfg)), v


def _out_proj(p, ctx, head_weights, cfg):
    """ctx (B,S,Hl,Dh) of the rank's heads, weighted by its slice of the
    (B,S,H) head weights, through its rows of ``wo``; the partial sums
    all-reduced over the ``model`` axis."""
    if head_weights is not None:
        hw = _local_heads(head_weights, cfg, -1)
        ctx = ctx * hw[..., None].to(ctx.dtype)
    return C.all_reduce_sum(Q.scaled(torch.einsum(
        "bshk,hkd->bsd", ctx, Q.widened(p, "wo", ctx.dtype)), p, "wo"))


def attn_apply(p, x, *, cfg, positions, causal: bool = True, window: int = 0,
               kv_valid=None, kv_count=None, head_weights=None, lora=None,
               backend=None, gathered: bool = False, kv_x=None):
    """Full-sequence attention (training, prefill) through the
    flash-attention op, which masks by array index: ``positions`` ((S,), or
    (B, S) per row for RoPE) must ascend along the rows. ``gathered``
    declares a RoutingPlan buffer (a position-ascending subset, ragged
    ``kv_count``): index-causal is position-causal there, but a sliding
    window measures position distance, so windowed gathered attention
    takes ``windowed_gathered_attention`` (masked by position), as the JAX
    package takes its jnp path. head_weights: (B,Sq,H) f32 head-routing
    weights applied to each head's context before the output projection.

    ``kv_x`` (B, Sk, D): cross-attention, keys and values projected from
    the context (image or encoder output), queries and keys without RoPE,
    never causal (the JAX package's ``kv_x`` with ``use_rope=False``);
    ``kv_valid`` (B, Sk) marks its selected rows. Returns (out (B,Sq,D),
    k, v) — k/v for the cache."""
    cross = kv_x is not None
    q = _project_q(p, x, positions, cfg, lora, use_rope=not cross)
    if cross:
        k, v = _project_kv(p, kv_x, None, cfg, lora, use_rope=False)
    else:
        k, v = _project_kv(p, x, positions, cfg, lora)
    if kv_valid is not None and kv_valid.dim() == 1:
        kv_valid = kv_valid.expand(k.shape[:2])
    ke, ve = _expand_kv(k, cfg), _expand_kv(v, cfg)
    if gathered and window and window > 0 and not cross:
        pos = positions if positions.dim() == 2 else \
            positions.expand(x.shape[:2])
        ctx = windowed_gathered_attention(q, ke, ve, pos, window, causal,
                                          kv_valid)
    else:
        ctx = OPS.flash_attention(q, ke, ve, kv_valid=kv_valid,
                                  kv_count=kv_count,
                                  causal=causal and not cross,
                                  window=window or 0, backend=backend)
    return _out_proj(p, ctx, head_weights, cfg), k, v


def windowed_gathered_attention(q, k, v, positions, window: int,
                                causal: bool = True, kv_valid=None):
    """Sliding-window self-attention over a gathered RoutingPlan buffer,
    masked by POSITION: q (B,S,H,Dh), k, v (B,S,K,Dh), ``positions`` (B,S)
    the rows' absolute positions. Key j is attendable from query i iff
    (causal) pos_j <= pos_i, pos_i - pos_j < window and kv_valid[j]. The
    JAX package's ``_mask`` + ``sdpa`` (its non-kernel path for this case):
    scores in the operands' dtype, scaled and masked (-1e30) in f32, f32
    softmax cast to v's dtype for P V. One masked SDPA stands in for the
    JAX package's ``blocked_sdpa`` beyond 2048 keys (the same math in one
    block); a row with no attendable key (a masked plan row, weighted 0
    by its caller) averages every value, as there. Plain PyTorch: no
    kernel serves this mask. Returns (B,S,H,Dh)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * Dh ** -0.5
    qp, kp = positions[:, :, None], positions[:, None, :]
    allow = (qp - kp) < window
    if causal:
        allow = allow & (kp <= qp)
    if kv_valid is not None:
        allow = allow & kv_valid[:, None, :]
    s = s.masked_fill(~allow[:, None, None], NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", a, v).reshape(B, S, H, Dh)


def cross_attn_decode(p, x, cache, *, cfg):
    """Decode-time cross-attention of one token per row over a slot's
    context cache {'k','v': (B,T,K,Dh), 'valid': (B,T) bool}, written at
    admission. Plain PyTorch, as the JAX package computes it (its jnp
    ``sdpa``, outside any Pallas kernel): f32 softmax over the valid rows;
    a row with no valid context row (an empty slot) gives exact zeros.
    Returns out (B,1,D)."""
    B = x.shape[0]
    Dh = cfg.d_head
    k, v, valid = _expand_kv(cache["k"], cfg), _expand_kv(cache["v"], cfg), \
        cache["valid"]
    K = k.shape[2]
    q = _project_q(p, x, None, cfg, None, use_rope=False)      # (B,1,H,Dh)
    H = q.shape[2]
    qg = q.reshape(B, K, H // K, Dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * Dh ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    live = valid.any(-1)[:, None, None, None]
    pr = torch.softmax(torch.where(live, s, torch.zeros_like(s)), dim=-1)
    pr = torch.where(live, pr, torch.zeros_like(pr))
    ctx = torch.einsum("bkgt,btkd->bkgd", pr, v.float())
    return _out_proj(p, ctx.reshape(B, 1, H, Dh).to(x.dtype), None, cfg)


def attn_decode(p, x, cache, t, *, cfg, window: int = 0, head_weights=None,
                lora=None, write: Optional[torch.Tensor] = None,
                backend=None):
    """One decode step. x: (B,1,D); cache: {'k','v': (B,L,K,Dh), 'valid':
    (B,L) bool, 'pos': (B,L) int32}; t: (B,) int32 per-row positions (or a
    scalar: every row at the same position).

    The cache is a RING: position p lives at slot p % L, ``pos`` holds the
    absolute positions (-1 = empty). Each row writes its own slot IN PLACE
    (the JAX package scatters functionally); ``write`` (B,) bool is the
    token gate — a skipped token leaves the old k/v but still consumes the
    slot (``pos`` = t, ``valid`` = False). Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    t = torch.as_tensor(t, device=x.device).to(torch.int32).reshape(-1)
    t = t.expand(B)
    pos = t[:, None]
    q = _project_q(p, x, pos, cfg, lora)
    k_new, v_new = _project_kv(p, x, pos, cfg, lora)
    wr = torch.ones((B,), dtype=torch.bool, device=x.device) \
        if write is None else write
    slots = torch.remainder(t, L).long()
    bi = torch.arange(B, device=x.device)
    for name, new in _stored(cache, "k", "v", k_new, v_new):
        c = cache[name]
        old = c[bi, slots]                       # (B, K, Dh) / scales (B, K)
        keep = wr.reshape((B,) + (1,) * (old.dim() - 1))
        c[bi, slots] = torch.where(keep, new[:, 0].to(c.dtype), old)
    cache["valid"][bi, slots] = wr
    cache["pos"][bi, slots] = t
    ctx = OPS.decode_attention(q, *_read_kv(cache, "k", "v", cfg),
                               cache["pos"], t, cache["valid"],
                               *_read_scales(cache, cfg), window=window or 0,
                               backend=backend)
    return _out_proj(p, ctx, head_weights, cfg), cache


def _read_kv(cache, kname, vname, cfg):
    """The cache's K and V as a decode reads them: the rank's own, or
    (padded heads) expanded to its q-heads."""
    return _expand_kv(cache[kname], cfg), _expand_kv(cache[vname], cfg)


def _read_scales(cache, cfg):
    """An int8 cache's (kscale, vscale), expanded like K and V; (None,
    None) for a float cache."""
    if "kscale" not in cache:
        return None, None
    return _expand_kv(cache["kscale"], cfg), _expand_kv(cache["vscale"], cfg)


def _stored(cache, kname, vname, k_new, v_new):
    """The (leaf name, new rows) pairs a write site stores: k and v as
    they are, or (``kscale`` in the cache) their int8 codes and f32
    scales, quantized here, once."""
    if "kscale" not in cache:
        return ((kname, k_new), (vname, v_new))
    kq, ks = Q.quantize_kv(k_new)
    vq, vs = Q.quantize_kv(v_new)
    return ((kname, kq), (vname, vq), ("kscale", ks), ("vscale", vs))


def _scale_leaves(cache: dict, shape, kv_dtype: str, device) -> dict:
    """An int8 cache's ``kscale``/``vscale`` leaves of ``shape``, set to
    1.0 as the JAX package sets them."""
    if kv_dtype == "int8":
        for name in ("kscale", "vscale"):
            cache[name] = torch.ones(shape, dtype=torch.float32,
                                     device=device)
    return cache


def attn_cache_init(cfg, batch: int, max_seq: int, window: int = 0,
                    device=None, kv_dtype: str = "fp32") -> dict:
    """Ring cache of length window (local layers) or max_seq (global).
    ``kv_dtype``: "fp32" stores the config dtype, "bf16" a plain cast,
    "int8" codes with per-(slot, token, kv-head) f32 ``kscale``/``vscale``
    leaves."""
    L = min(max_seq, window) if window and window > 0 else max_seq
    K, Dh = cfg.n_kv_heads, cfg.d_head
    dt = Q.kv_store_dtype(Q.check_kv_dtype(kv_dtype), dtype_of(cfg))
    cache = {
        "k": torch.zeros((batch, L, K, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, L, K, Dh), dtype=dt, device=device),
        "valid": torch.zeros((batch, L), dtype=torch.bool, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }
    return _scale_leaves(cache, (batch, L, K), kv_dtype, device)


# ------------------------------ paged KV pool --------------------------------
#
# The block-paged twin of the ring cache (runtime/pagedkv.py): one GLOBAL
# per-layer pool of (n_pages, page_size, K, Dh) pages shared by every
# serving slot, addressed through per-slot int32 page-table rows. Position
# t of slot b lives at (table[b, t // page_size], t % page_size): the
# position is implicit in the table layout, so there is no `pos` array;
# `pvalid` carries the ElastiFormer token-gate keep decision per lane.


def attn_paged_cache_init(cfg, n_pages: int, page_size: int,
                          device=None, kv_dtype: str = "fp32") -> dict:
    """One layer's slice of the global page pool; ``kv_dtype`` as in
    ``attn_cache_init`` (int8: per-(page, lane, kv-head) scale pools)."""
    K, Dh = cfg.n_kv_heads, cfg.d_head
    dt = Q.kv_store_dtype(Q.check_kv_dtype(kv_dtype), dtype_of(cfg))
    cache = {
        "kp": torch.zeros((n_pages, page_size, K, Dh), dtype=dt,
                          device=device),
        "vp": torch.zeros((n_pages, page_size, K, Dh), dtype=dt,
                          device=device),
        "pvalid": torch.zeros((n_pages, page_size), dtype=torch.bool,
                              device=device),
    }
    return _scale_leaves(cache, (n_pages, page_size, K), kv_dtype, device)


def attn_decode_paged(p, x, cache, t, table, trash, *, cfg,
                      head_weights=None, lora=None,
                      write: Optional[torch.Tensor] = None, backend=None):
    """One decode step over the paged pool. x: (B,1,D); cache: {'kp','vp':
    (N, ps, K, Dh), 'pvalid': (N, ps)}; t: (B,) int32 per-slot positions;
    table: (B, P) int32 page-table rows (-1 = unused entry; the host backs
    entry t // ps of every ACTIVE slot); trash: (B,) int32 per-slot trash
    page ids. Each row writes its (page, lane) IN PLACE; rows whose entry
    is -1 (inactive slots) write to their trash page, so the write never
    lands on a live page. ``write``: (B,) bool token gate — a skipped token
    keeps the old k/v and clears the lane's ``pvalid``. Returns
    (out (B,1,D), cache)."""
    B = x.shape[0]
    ps = cache["kp"].shape[1]
    P = table.shape[1]
    t = torch.as_tensor(t, device=x.device).to(torch.int32).reshape(-1)
    t = t.expand(B)
    pos = t[:, None]
    q = _project_q(p, x, pos, cfg, lora)
    k_new, v_new = _project_kv(p, x, pos, cfg, lora)
    wr = torch.ones((B,), dtype=torch.bool, device=x.device) \
        if write is None else write
    # an inactive slot's stale t may point past the table: clamp (its row
    # is all -1, so it lands on the trash page either way)
    ent = (t // ps).long().clamp(max=P - 1)
    entries = table.gather(1, ent[:, None])[:, 0]
    # global ids (the table's, the trash pages') into the rank's pool
    pages = torch.where(entries >= 0, entries, trash).long() \
        - OPS.page_offset(cache["kp"].shape[0])
    offs = torch.remainder(t, ps).long()
    for name, new in _stored(cache, "kp", "vp", k_new, v_new):
        c = cache[name]
        old = c[pages, offs]                     # (B, K, Dh) / scales (B, K)
        keep = wr.reshape((B,) + (1,) * (old.dim() - 1))
        c[pages, offs] = torch.where(keep, new[:, 0].to(c.dtype), old)
    cache["pvalid"][pages, offs] = wr
    ctx = OPS.paged_decode_attention_sharded(
        q, *_read_kv(cache, "kp", "vp", cfg), table, t, cache["pvalid"],
        *_read_scales(cache, cfg), backend=backend)
    return _out_proj(p, ctx, head_weights, cfg), cache


def as_index(v, device) -> torch.Tensor:
    """A page id or a row as a (1,) int64 index on ``device``: a 0-d
    device tensor (the serving engine's captured chunk reads its operands
    from static buffers) stays on the device, never read by the host; a
    Python int becomes a one-element tensor."""
    if torch.is_tensor(v):
        return v.reshape(1).long()
    return torch.tensor([int(v)], dtype=torch.int64, device=device)


def attn_chunk(p, x, cache, write_page, table_row, pos0, plen, *, cfg,
               keep=None, head_weights=None, lora=None, backend=None):
    """One CHUNK of a paged prefill, shaped like a decode: x is (1, C, D)
    with C == page_size, covering absolute positions [pos0, pos0 + C). The
    chunk's K/V fill exactly ONE page (``write_page``; the trash page when
    this chunk's prefix page is shared and the chunk only recomputes its
    queries), in place; then each of the C queries attends over the pages
    of ``table_row`` (P,) up to its own position — C rows of the paged
    decode op with the same table row. ``keep``: (1, C) token gate; lanes
    at positions >= plen (chunk padding) are never marked valid.
    ``write_page``, ``pos0`` and ``plen``: Python ints or 0-d int device
    tensors (no host read either way). Returns (out (1, C, D), cache)."""
    B, C, _ = x.shape
    Dh = cfg.d_head
    positions = pos0 + torch.arange(C, dtype=torch.int32,
                                    device=x.device)[None, :]   # (1, C)
    q = _project_q(p, x, positions, cfg, lora)
    k_new, v_new = _project_kv(p, x, positions, cfg, lora)
    wr = torch.ones((B, C), dtype=torch.bool, device=x.device) \
        if keep is None else keep
    wr = wr & (positions < plen)
    wp = as_index(write_page, x.device) \
        - OPS.page_offset(cache["kp"].shape[0])
    for name, new in _stored(cache, "kp", "vp", k_new, v_new):
        cache[name].index_copy_(0, wp, new.to(cache[name].dtype))
    cache["pvalid"].index_copy_(0, wp, wr)
    table = table_row.reshape(1, -1).expand(C, -1)
    H = q.shape[2]
    ctx = OPS.paged_decode_attention_sharded(
        q.reshape(C, 1, H, Dh), *_read_kv(cache, "kp", "vp", cfg), table,
        positions[0], cache["pvalid"], *_read_scales(cache, cfg),
        backend=backend)
    return _out_proj(p, ctx.reshape(B, C, H, Dh), head_weights, cfg), cache
