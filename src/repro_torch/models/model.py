"""Model assembly: embedding, the layer stack, LM head; prefill and ring
decode, paged decode and chunked paged prefill; ElastiFormer router
attachment.

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
import torch.utils.checkpoint

from repro_torch.core.policy import as_spec_policy
from repro_torch.device import resolve_device
from repro_torch.core.routing import RouteAux
from repro_torch.models.attention import as_index
from repro_torch.models.blocks import (block_apply, block_cache_init,
                                       block_chunk, block_decode, block_init,
                                       block_paged_cache_init,
                                       block_router_init, cache_row_insert)
from repro_torch.models.layers import dense_init, dtype_of, norm_apply, norm_init


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
    ``gen`` (which must live on ``device``; None = the CUDA card)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    params = {"final_norm": norm_init(D, cfg.norm, device=device),
              "embed": dense_init(gen, V, D, dt, scale=0.02, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, D, V, dt, device=device)
    params["layers"] = [block_init(gen, kind, cfg, device=device)
                        for kind in cfg.layer_kinds]
    return params


def router_init(gen: torch.Generator, cfg, elastic, device=None) -> dict:
    """Trainable ElastiFormer parameters, one dict per layer."""
    device = resolve_device(device)
    spec, _ = as_spec_policy(elastic)
    return {"layers": [block_router_init(gen, kind, cfg, spec, device=device)
                       for kind in cfg.layer_kinds]}


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
    return params["embed"][tokens.long()]


def _logits(params, cfg, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:
        v = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(v, logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=x.device))
    return logits


def _layer_policies(pol, n_layers: int) -> list:
    """Each layer's policy, resolved once per call: ``pol.for_layer(i)``
    for a per-layer schedule, else ``pol`` itself."""
    if pol is not None and pol.has_layer_dim:
        return [pol.for_layer(i) for i in range(n_layers)]
    return [pol] * n_layers


def _run(params, rparams, x, *, cfg, spec, pol, mode, collect_cache=False,
         max_cache_len=0, bucket=None, remat=False):
    """The layer loop (the JAX pattern scan). ``remat``: each layer under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward
    pass; the recomputed RoutingPlan is the same plan, the sort being
    stable and the kernels deterministic)."""
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
                window=ent.window, causal=True, collect_cache=collect_cache,
                max_cache_len=max_cache_len, bucket=bucket)
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


def forward(params, rparams, batch, cfg, ecfg=None, mode: str = "base",
            return_hidden: bool = False, remat: bool = False, policy=None,
            bucket=None):
    """Full-sequence forward. Returns (logits | hidden, aux).
    ``bucket``: the static ragged bucket hint for a tensor policy in train
    mode (``policy.ragged_bucket``; ``routing.IDENTITY_BUCKET`` for an
    all-full policy); ``remat``: recompute each layer in the backward."""
    spec, pol = as_spec_policy(ecfg, policy)
    x = _embed(params, batch["tokens"])
    x, aux, _ = _run(params, rparams, x, cfg=cfg, spec=spec, pol=pol,
                     mode=mode, bucket=bucket, remat=remat)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    return _logits(params, cfg, x), aux


# ------------------------------ serving --------------------------------------

def cache_init(cfg, batch: int, max_seq: int, device=None,
               kv_dtype: str = "fp32") -> dict:
    """Every layer's ring cache; ``kv_dtype`` fp32 | bf16 | int8 (int8 adds
    the ``kscale``/``vscale`` leaves)."""
    device = resolve_device(device)
    return {"layers": [block_cache_init(k, cfg, batch, max_seq,
                                        window=cfg.layer_windows[i],
                                        device=device, kv_dtype=kv_dtype)
                       for i, k in enumerate(cfg.layer_kinds)]}


def prefill(params, rparams, batch, cfg, ecfg=None, mode: str = "infer",
            max_cache_len: int = 0, policy=None, bucket=None):
    """Forward + cache collection. Returns (last-token logits (B,V), caches
    laid out as ring caches of length ``max_cache_len`` (default S)).
    ``bucket``: the static ragged bucket hint of a train-mode (top-k)
    prefill under a tensor policy (``policy.ragged_bucket``)."""
    spec, pol = as_spec_policy(ecfg, policy)
    x = _embed(params, batch["tokens"])
    x, _, caches = _run(params, rparams, x, cfg=cfg, spec=spec, pol=pol,
                        mode=mode, collect_cache=True,
                        max_cache_len=max_cache_len or x.shape[1],
                        bucket=bucket)
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
