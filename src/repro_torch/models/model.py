"""Model assembly: embedding, the layer stack, LM head; prefill and ring
decode, paged decode and chunked paged prefill; ElastiFormer router
attachment; the context families: the bidirectional encoder
(``family="encoder"``, a ViT over patch embeddings), the VLM (image
embeddings projected by ``in_proj``, top-k selected by the ``vlm`` router
and cross-attended by the ``xattn`` layers) and the encoder-decoder (a
nested encoder stack over frames, run non-causally, whose output is
selected and cross-attended the same way).

Params are plain dicts of tensors with the JAX package's leaf names and
layouts; the layers are a Python list (``params["layers"][i]``) that a loop
runs, where the JAX package stacks them per pattern position and runs a
``lax.scan`` (``interop.py`` converts between the two).

Entry points take ``elastic`` as an ``ElasticSpec`` (or the legacy
``ElasticConfig``) plus an optional ``ElasticPolicy`` whose tensor leaves
(``()`` or ``(B,)``) serve every budget with the same code and shapes;
``(L, 1)`` / ``(L, B)`` leaves are per-layer schedules (layer i runs
``policy.for_layer(i)``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import routing as R
from repro_torch.core.policy import as_spec_policy
from repro_torch.device import resolve_device
from repro_torch.core.routing import RouteAux
from repro_torch.models.attention import as_index
from repro_torch.models.blocks import (block_apply, block_cache_init,
                                       block_chunk, block_decode, block_init,
                                       block_paged_cache_init,
                                       block_router_init, cache_row_insert)
from repro_torch.models.layers import dense_init, dtype_of, norm_apply, norm_init
from repro_torch.runtime import collectives as C
from repro_torch.runtime.mesh import active_mesh


class PatternPos(NamedTuple):
    kind: str
    window: int
    elastic: bool


def build_pattern(cfg, elastic=None):
    """Returns (period: tuple[PatternPos], P, R): the repeating layer
    pattern, its number of full repeats and the remainder layers.
    ``elastic`` is an ElasticSpec or ElasticConfig (only .layers matters)."""
    n = cfg.n_layers
    base = math.lcm(len(cfg.mixer_pattern), len(cfg.window_pattern))
    if elastic is not None and elastic.layers == "even":
        base = math.lcm(base, 2)
    period_len = base if base <= n else n
    kinds, wins = cfg.layer_kinds, cfg.layer_windows
    applies = (lambda i: True) if elastic is None else elastic.applies_to_layer
    period = tuple(PatternPos(kinds[j], wins[j], applies(j))
                   for j in range(period_len))
    return period, n // period_len, n % period_len


def layer_entries(cfg, elastic=None):
    """The PatternPos of every layer, in order."""
    period, _, _ = build_pattern(cfg, elastic)
    return [period[i % len(period)] for i in range(cfg.n_layers)]


def stack_layers(per_layer: list, period_len: int):
    """[L trees] -> (scan: period_len trees stacked over P, tail: R trees),
    the JAX package's layout: layer i = p * period_len + j."""
    P = len(per_layer) // period_len

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    scan = [stack(*[per_layer[p * period_len + j] for p in range(P)])
            for j in range(period_len)] if P else []
    return scan, per_layer[P * period_len:]


def unstack_layers(scan: list, tail: list, P: int) -> list:
    """Inverse of ``stack_layers`` (P = number of stacked periods)."""
    def pick(t, p):
        if isinstance(t, dict):
            return {k: pick(v, p) for k, v in t.items()}
        return t[p]

    return [pick(scan[j], p) for p in range(P)
            for j in range(len(scan))] + list(tail)


# ------------------------------- init ---------------------------------------

def model_init(gen: torch.Generator, cfg, elastic=None, device=None) -> dict:
    """Base params with the JAX package's shapes and init scales, drawn from
    ``gen`` (which must live on ``device``; None = the CUDA card). An
    encoder (no vocabulary) has no embedding or head; a VLM or encoder
    has the frontend projection ``in_proj`` (d_frontend, D); an
    encoder-decoder nests its encoder's params under ``encoder``."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    params = {"final_norm": norm_init(D, cfg.norm, device=device)}
    if V:
        params["embed"] = dense_init(gen, V, D, dt, scale=0.02, device=device)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, D, V, dt, device=device)
    params["layers"] = [block_init(gen, kind, cfg, device=device)
                        for kind in cfg.layer_kinds]
    if cfg.family in ("encoder", "vlm") or cfg.d_frontend:
        params["in_proj"] = dense_init(gen, cfg.d_frontend or D, D, dt,
                                       device=device)
    if cfg.encoder is not None:
        params["encoder"] = model_init(gen, cfg.encoder, elastic, device)
    return params


def router_init(gen: torch.Generator, cfg, elastic, device=None) -> dict:
    """Trainable ElastiFormer parameters, one dict per layer; with the
    spec's ``vlm_routed``, the context-token router ``vlm`` (linear, or
    the MLP of ``spec.vlm_router == "mlp"``) of a VLM or encoder-decoder;
    an encoder-decoder's encoder routers under ``encoder``."""
    device = resolve_device(device)
    spec, _ = as_spec_policy(elastic)
    rp = {"layers": [block_router_init(gen, kind, cfg, spec, device=device)
                     for kind in cfg.layer_kinds]}
    if spec.vlm_routed and (cfg.family in ("vlm", "encdec")
                            or cfg.n_image_tokens):
        D = cfg.d_model
        if spec.vlm_router == "mlp":
            h = spec.vlm_router_hidden or D
            f32 = torch.float32
            rp["vlm"] = {
                "w1": dense_init(gen, D, h, f32, device=device),
                "b1": torch.zeros((h,), dtype=f32, device=device),
                "w2": dense_init(gen, h, 1, f32, device=device),
                "b2": torch.zeros((), dtype=f32, device=device)}
        else:
            rp["vlm"] = R.token_router_init(gen, D, device=device)
    if cfg.encoder is not None:
        rp["encoder"] = router_init(gen, cfg.encoder, spec, device=device)
    return rp


def router_param_count(rp) -> int:
    """Number of trainable router parameters (token, head and expert
    routers, LoRA)."""
    if isinstance(rp, dict):
        return sum(router_param_count(v) for v in rp.values())
    if isinstance(rp, (list, tuple)):
        return sum(router_param_count(v) for v in rp)
    return rp.numel()


# ------------------------------ forward --------------------------------------

def _embed(params, tokens):
    """The embedding lookup. Under a mesh ``embed`` holds the rank's V/M
    vocabulary rows: a masked lookup of the rows it holds (zeros for the
    others), all-reduced."""
    emb = params["embed"]
    r, m = C.tp_rank_size()
    if m == 1:
        return emb[tokens.long()]
    vl = emb.shape[0]
    ids = tokens.long() - r * vl
    mine = (ids >= 0) & (ids < vl)
    rows = emb[ids.clamp(0, vl - 1)]
    return C.all_reduce_sum(rows * mine[..., None].to(rows.dtype))


def _logits(params, cfg, x):
    """x @ the LM head. Under a mesh the head holds the rank's V/M
    columns: the local logits are all-gathered over the vocabulary, so
    sampling sees whole rows; the padded-vocabulary mask applies to the
    gathered row."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if logits.shape[-1] != cfg.padded_vocab:
        logits = C.all_gather(logits, dim=-1)
    if cfg.padded_vocab != cfg.vocab_size:
        v = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(v, logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=x.device))
    return logits


def check_mesh(cfg, spec) -> None:
    """What serving on a (data, model) mesh covers under an active mesh
    (ROADMAP Queue A item 11): decoder-only self-attention stacks with
    dense MLPs, on the ring and the paged layout. Refuses the rest,
    naming the part of item 11 that brings it."""
    mesh = active_mesh()
    if mesh is None or mesh.size == 1:
        return
    later = "arrives with ROADMAP Queue A item 11"
    bad = sorted({k for k in cfg.layer_kinds if k != "attn"})
    if bad or cfg.encoder is not None or cfg.family in ("vlm", "encoder"):
        raise NotImplementedError(
            f"serving {bad or cfg.family!r} layers on a mesh {later} (the "
            f"recurrent and context families on a mesh)")
    if cfg.moe is not None or (spec is not None and spec.mlp_n_experts):
        raise NotImplementedError(f"experts on a mesh {later} (part 5, "
                                  f"expert parallelism)")


def _layer_policies(pol, n_layers: int) -> list:
    """Each layer's policy, resolved once per call: ``pol.for_layer(i)``
    for a per-layer schedule, else ``pol`` itself."""
    if pol is not None and pol.has_layer_dim:
        return [pol.for_layer(i) for i in range(n_layers)]
    return [pol] * n_layers


def _vlm_logits(rp, emb):
    if "w1" in rp:                  # the MLP router (paper §5.3)
        h = F.gelu(emb.float() @ rp["w1"] + rp["b1"], approximate="tanh")
        return (h @ rp["w2"])[..., 0] + rp["b2"]
    return emb.float() @ rp["w"] + rp["b"]


def select_context_tokens(rp, emb, spec, pol, mode: str):
    """Paper §5.3: top-k selection of the image (or encoder-output) tokens
    before the decoder, weighted by the ``vlm`` router's sigmoid. The
    context is not causal, so top-k applies at inference too. A static
    capacity gathers the (B, k, D) subset, position-ascending (smaller
    cross-attention); a tensor one keeps the full (B, T, D) shape and
    returns the (B, T) validity mask with it, so the same code serves
    every context budget. Full budget (or ``mode="base"``, or no router)
    returns ``emb`` unweighted. Returns (context, valid or None)."""
    if mode == "base" or rp is None or "vlm" not in rp \
            or spec is None or not spec.vlm_routed:
        return emb, None
    B, T, _ = emb.shape
    cap = pol.vlm_token_capacity if pol is not None else 1.0
    cap = R.gate_capacity(cap, pol.student if pol is not None else None)
    scores = torch.sigmoid(_vlm_logits(rp["vlm"], emb))
    if R.is_static(cap):
        if cap >= 1.0:
            return emb, None
        idx = R.topk_indices(scores, max(1, int(math.ceil(cap * T))))
        w = R.gather_tokens(scores, idx)
        return R.gather_tokens(emb, idx) * w[..., None].to(emb.dtype), None
    keep = R.topk_mask_dyn(scores, R.capacity_k(cap, T))
    full = R.bcast_to(R.is_full(cap), keep.dim())
    keep = keep | full
    w = torch.where(full, torch.ones_like(scores), keep * scores)
    return emb * w[..., None].to(emb.dtype), keep


def _run(params, rparams, x, *, cfg, spec, pol, mode, collect_cache=False,
         max_cache_len=0, bucket=None, remat=False, causal=True, enc_kv=None,
         enc_valid=None):
    """The layer loop (the JAX pattern scan). ``remat``: each layer under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward
    pass; the recomputed RoutingPlan is the same plan, the sort being
    stable and the kernels deterministic). ``causal=False``: an encoder;
    ``enc_kv``/``enc_valid``: the context the ``xattn`` layers attend to."""
    has_rp = rparams is not None and mode != "base"
    aux = RouteAux.zero(x.device)
    caches = []
    pols = _layer_policies(pol, cfg.n_layers)
    for i, ent in enumerate(layer_entries(cfg, spec)):
        def layer(x, i=i, ent=ent):
            return block_apply(
                ent.kind, params["layers"][i],
                rparams["layers"][i] if has_rp else None, x, cfg=cfg,
                spec=spec, pol=pols[i], mode=mode, elastic_on=ent.elastic,
                window=ent.window, causal=causal,
                collect_cache=collect_cache, max_cache_len=max_cache_len,
                bucket=bucket, enc_kv=enc_kv, enc_valid=enc_valid)
        if remat:
            out = torch.utils.checkpoint.checkpoint(layer, x,
                                                    use_reentrant=False)
        else:
            out = layer(x)
        x, a = out[0], out[1]
        aux = aux + a
        if collect_cache:
            caches.append(out[2])
    return x, aux, caches


def _context(params, rparams, batch, cfg, spec, pol, mode, remat=False):
    """The ``xattn`` layers' context -> (enc_kv, enc_valid, the encoder's
    routing aux or None). A VLM's
    ``image_embeds`` (B, T, d_frontend), cast to the model dtype and
    projected by ``in_proj``; an encoder-decoder's ``frames`` through
    ``in_proj`` and the encoder stack (non-causal, its routers under
    ``rparams["encoder"]`` fed by the same policy, no ``bucket``: the
    caller's bucket is solved for the decoder's length, so tensor
    capacities take the dense path there). Both then go through
    ``select_context_tokens``."""
    if cfg.family == "vlm":
        emb = batch["image_embeds"].to(dtype_of(cfg)) @ params["in_proj"]
        emb, valid = select_context_tokens(rparams, emb, spec, pol, mode)
        return emb, valid, None
    if cfg.encoder is not None:
        enc_p = params["encoder"]
        enc_rp = rparams.get("encoder") if (rparams and mode != "base") \
            else None
        x = batch["frames"].to(dtype_of(cfg)) @ enc_p["in_proj"]
        x, aux, _ = _run(enc_p, enc_rp, x, cfg=cfg.encoder, spec=spec,
                         pol=pol, mode=mode, remat=remat, causal=False)
        x = norm_apply(enc_p["final_norm"], x, cfg.encoder.norm)
        x, valid = select_context_tokens(rparams, x, spec, pol, mode)
        return x, valid, aux
    return None, None, None


def forward(params, rparams, batch, cfg, ecfg=None, mode: str = "base",
            return_hidden: bool = False, remat: bool = False, policy=None,
            bucket=None):
    """Full-sequence forward. Returns (logits | hidden | embeddings, aux).
    ``bucket``: the static ragged bucket hint for a tensor policy in train
    mode (``policy.ragged_bucket``; ``routing.IDENTITY_BUCKET`` for an
    all-full policy); ``remat``: recompute each layer in the backward.
    An encoder (``family="encoder"``) takes ``batch["embeds"]`` and returns
    its final-normed output embeddings; a VLM adds ``image_embeds``, an
    encoder-decoder ``frames`` to ``tokens``."""
    spec, pol = as_spec_policy(ecfg, policy)
    check_mesh(cfg, spec)
    if cfg.family == "encoder":
        x = batch["embeds"].to(dtype_of(cfg)) @ params["in_proj"]
        x, aux, _ = _run(params, rparams, x, cfg=cfg, spec=spec, pol=pol,
                         mode=mode, bucket=bucket, remat=remat,
                         causal=False)
        return norm_apply(params["final_norm"], x, cfg.norm), aux
    enc_kv, enc_valid, aux0 = _context(params, rparams, batch, cfg, spec,
                                       pol, mode, remat)
    x = _embed(params, batch["tokens"])
    x, aux, _ = _run(params, rparams, x, cfg=cfg, spec=spec, pol=pol,
                     mode=mode, bucket=bucket, remat=remat, enc_kv=enc_kv,
                     enc_valid=enc_valid)
    if aux0 is not None:
        aux = aux + aux0
    x = norm_apply(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    return _logits(params, cfg, x), aux


# ------------------------------ serving --------------------------------------

def cache_init(cfg, batch: int, max_seq: int, device=None,
               kv_dtype: str = "fp32") -> dict:
    """Every layer's ring cache; ``kv_dtype`` fp32 | bf16 | int8 (int8 adds
    the ``kscale``/``vscale`` leaves). An ``xattn`` layer adds its context
    cache of ``n_image_tokens`` (VLM) or ``encoder_seq`` (encoder-decoder)
    rows."""
    device = resolve_device(device)
    enc_len = cfg.n_image_tokens or cfg.encoder_seq
    return {"layers": [block_cache_init(k, cfg, batch, max_seq, enc_len,
                                        window=cfg.layer_windows[i],
                                        device=device, kv_dtype=kv_dtype)
                       for i, k in enumerate(cfg.layer_kinds)]}


def prefill(params, rparams, batch, cfg, ecfg=None, mode: str = "infer",
            max_cache_len: int = 0, policy=None, bucket=None):
    """Forward + cache collection. Returns (last-token logits (B,V), caches
    laid out as ring caches of length ``max_cache_len`` (default S)).
    ``bucket``: the static ragged bucket hint of a train-mode (top-k)
    prefill under a tensor policy (``policy.ragged_bucket``). A VLM's or
    encoder-decoder's batch carries its context (``image_embeds`` /
    ``frames``); each ``xattn`` layer's cache then holds the context's
    K/V and selected rows."""
    spec, pol = as_spec_policy(ecfg, policy)
    check_mesh(cfg, spec)
    enc_kv, enc_valid, _ = _context(params, rparams, batch, cfg, spec, pol,
                                    mode)
    x = _embed(params, batch["tokens"])
    x, _, caches = _run(params, rparams, x, cfg=cfg, spec=spec, pol=pol,
                        mode=mode, collect_cache=True,
                        max_cache_len=max_cache_len or x.shape[1],
                        bucket=bucket, enc_kv=enc_kv, enc_valid=enc_valid)
    x = norm_apply(params["final_norm"], x[:, -1], cfg.norm)
    return _logits(params, cfg, x), {"layers": caches}


def cache_insert(caches, row_caches, slot: int):
    """Copy a single-request cache (batch dim 1, prefilled at the slot
    array's length) into row ``slot`` of the live slot-array cache, in
    place. Returns the live cache."""
    for full, row in zip(caches["layers"], row_caches["layers"]):
        cache_row_insert(full, row, slot)
    return caches


def prefill_into_slot(params, rparams, batch, caches, slot: int, cfg,
                      ecfg=None, mode: str = "infer", max_cache_len: int = 0,
                      policy=None, live_policy=None, bucket=None):
    """Admission path for continuous batching: prefill ONE request, copy its
    caches into row ``slot`` and splice its policy row into the live
    (B,)-leaf policy, both in place (every live tensor keeps its storage).
    ``bucket``: as in ``prefill``. Returns (logits (1, V), caches,
    live_policy)."""
    logits, row = prefill(params, rparams, batch, cfg, ecfg, mode=mode,
                          max_cache_len=max_cache_len, policy=policy,
                          bucket=bucket)
    caches = cache_insert(caches, row, slot)
    if live_policy is not None and policy is not None:
        live_policy.set_row_(slot, policy)
    return logits, caches, live_policy


def decode_step(params, rparams, token, caches, t, cfg, ecfg=None,
                mode: str = "infer", policy=None, table=None, trash=None):
    """One decode step over the slot array. token: (B,1) int; t: (B,) int32
    per-row positions (or a scalar). The caches are updated in place.
    ``table``/``trash``: paged-KV mode, the (B, P) page-table rows and (B,)
    per-slot trash pages; one table serves every layer (each layer's pool
    slice is indexed with the same page ids). Returns (logits (B,V),
    caches)."""
    spec, pol = as_spec_policy(ecfg, policy)
    check_mesh(cfg, spec)
    x = _embed(params, token)
    has_rp = rparams is not None and mode != "base"
    pols = _layer_policies(pol, cfg.n_layers)
    for i, ent in enumerate(layer_entries(cfg, spec)):
        x, _ = block_decode(
            ent.kind, params["layers"][i],
            rparams["layers"][i] if has_rp else None, x,
            caches["layers"][i], t, cfg=cfg, spec=spec, pol=pols[i],
            mode=mode, elastic_on=ent.elastic, window=ent.window,
            table=table, trash=trash)
    x = norm_apply(params["final_norm"], x[:, -1], cfg.norm)
    return _logits(params, cfg, x), caches


# --------------------------- paged serving -----------------------------------

def paged_cache_init(cfg, n_pages: int, page_size: int, device=None,
                     kv_dtype: str = "fp32") -> dict:
    """Paged twin of ``cache_init``: every layer's slice of the GLOBAL page
    pool, ``{"layers": [{"attn": {"kp", "vp", "pvalid"[, "kscale",
    "vscale"]}}, ...]}``."""
    device = resolve_device(device)
    return {"layers": [block_paged_cache_init(k, cfg, n_pages, page_size,
                                              device=device,
                                              kv_dtype=kv_dtype)
                       for k in cfg.layer_kinds]}


def prefill_chunk_step(params, rparams, tokens, caches, write_page,
                       table_row, pos0, plen, cfg, ecfg=None,
                       mode: str = "infer", policy=None):
    """One CHUNK of a paged prefill through the whole stack: tokens is
    (1, C) int with C == page_size, zero-padded past ``plen``;
    ``write_page`` is the pool page this chunk's K/V land in at EVERY layer
    (the same id in each layer's pool slice); ``table_row`` (P,) int32 is
    the slot's page-table row (entries up to this chunk present); the
    chunk covers positions [pos0, pos0 + C). ``write_page``, ``pos0`` and
    ``plen`` are Python ints or 0-d int device tensors: given tensors, the
    step reads no value on the host, so one captured chunk serves every
    chunk of every prompt (the serving engine's). Chaining ceil(plen / C)
    calls prefills any prompt length with the same shapes. The pools are
    updated in place. Returns (logits (1, V) at the chunk's LAST REAL
    position, and the caches)."""
    spec, pol = as_spec_policy(ecfg, policy)
    check_mesh(cfg, spec)
    x = _embed(params, tokens)
    has_rp = rparams is not None and mode != "base"
    pols = _layer_policies(pol, cfg.n_layers)
    for i, ent in enumerate(layer_entries(cfg, spec)):
        x, _ = block_chunk(
            ent.kind, params["layers"][i],
            rparams["layers"][i] if has_rp else None, x,
            caches["layers"][i], write_page, table_row, pos0, plen, cfg=cfg,
            spec=spec, pol=pols[i], mode=mode, elastic_on=ent.elastic)
    last = plen - 1 - pos0           # the last real row, clamped to the chunk
    last = last.clamp(0, x.shape[1] - 1) if torch.is_tensor(last) else \
        min(max(last, 0), x.shape[1] - 1)
    x = x.index_select(1, as_index(last, x.device))[:, 0]
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), caches
