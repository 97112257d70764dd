"""Transformer blocks with ElastiFormer routing woven in.

Block kinds:
  attn  : [token-route] GQA self-attention [head-route] [LoRA]
          + [token-route] MLP or MoE [expert-route], pre-norm residual;
  xattn : the same, with a cross-attention sub-block between the two that
          attends to the image or encoder context (``enc_kv``, its
          selected rows ``enc_valid``): the VLM's image layers and every
          decoder layer of an encoder-decoder. The context K/V are
          projected once per request and kept in the cache's ``xattn``
          leaf for decode;
  ssm   : [token-route] the Mamba2 SSD mixer (``models/ssm.py``), no MLP;
  rglru : [token-route] the RG-LRU recurrent mixer (``models/rglru.py``)
          + MLP.

Token routing of a recurrent mixer is a dense mask (a skipped token leaves
the state untouched: dt = 0 / a = 1, an exact pass-through), taken from the
block plan's MEMBERSHIP in training (a recurrence cannot run on a gathered
subset) and from the threshold gate at inference, so the two modes mean the
same thing. Its cache is {'state', 'conv'}, written in place at decode.

Modes:
  base  : the frozen pretrained model (the distillation teacher): routers off.
  train : the student in distillation: top-k token routing (capacity c,
          Alg. 2), planned ONCE per block (``routing.make_plan``, one sort)
          and shared by the attention and MLP students; each weights the
          shared token set with its own router and BCE-trains it toward the
          shared membership. Full budget on every row takes the identity
          path: no sort, gather or scatter, the teacher's math bit for bit,
          the routers' aux losses still emitted.
  infer : the student at inference: each token router thresholds its
          sigmoid at theta (§B.1), head routing keeps the top-k heads.

Expert routing (the paper's parameter-subset router for the MLP): a
native MoE layer (``cfg.moe``) drives its experts with the learned
``expert`` router in place of its own; a dense MLP under
``spec.mlp_n_experts`` is split losslessly into experts (``core/moefy.py``,
views of the dense weights) and routed the same way. Both dispatch through
``models/moe.py`` and the ``moe_gmm`` kernel.

Depth routing (per-token whole-layer skip): the ``depth`` token router is
the block's OUTERMOST mixer router. Its selection drives the block's one
plan in training (unselected tokens ride the residual through attention
AND the MLP); at inference its threshold gate ANDs into the attention
keep (a skipped token writes no K/V at that layer: the ring's ``valid`` /
the pool's ``pvalid`` records the hole) and its weight scales the
attention and MLP deltas. Its capacity multiplies the token capacities
(``_mul_caps``).
"""
from __future__ import annotations

import torch

from repro_torch.core import routing as R
from repro_torch.core.lora import lora_init
from repro_torch.core.moefy import moefy_mlp
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as A
from repro_torch.models import quant as Q
from repro_torch.models import rglru as G
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (dtype_of, mlp_apply, mlp_init,
                                      norm_apply, norm_init)
from repro_torch.models.moe import moe_apply, moe_decode, moe_init
from repro_torch.runtime import collectives as C

KINDS = ("attn", "xattn", "ssm", "rglru")


def has_mlp(kind: str) -> bool:
    return kind != "ssm"


def is_attn(kind: str) -> bool:
    return kind in ("attn", "xattn")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"layer kind {kind!r} is not one of {KINDS}")


# ------------------------------ init ---------------------------------------

def block_init(gen, kind: str, cfg, device=None) -> dict:
    _check_kind(kind)
    p = {"norm1": norm_init(cfg.d_model, cfg.norm, device=device)}
    if is_attn(kind):
        p["attn"] = A.attn_init(gen, cfg, device=device)
    elif kind == "ssm":
        p["mixer"] = SSM.ssm_init(gen, cfg, device=device)
    else:
        p["mixer"] = G.rglru_init(gen, cfg, device=device)
    if kind == "xattn":
        p["xnorm"] = norm_init(cfg.d_model, cfg.norm, device=device)
        p["xattn"] = A.attn_init(gen, cfg, device=device)
    if has_mlp(kind):
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, device=device)
        p["mlp"] = (moe_init(gen, cfg, device=device) if cfg.moe is not None
                    else mlp_init(gen, cfg, device=device))
    return p


def block_router_init(gen, kind: str, cfg, spec, device=None) -> dict:
    """Trainable ElastiFormer params for one layer; ``spec`` alone decides
    which routers exist (an ``xattn`` block has the ``attn`` block's). A
    recurrent block has the token routers only: ``tok_mixer`` around its
    mixer, and ``tok_mlp``/``expert`` where it has an MLP."""
    _check_kind(kind)
    D = cfg.d_model
    rp = {}
    if spec.mha_token_routed:
        rp["tok_mixer"] = R.token_router_init(gen, D, device=device)
    if is_attn(kind) and spec.mha_head_routed:
        rp["head"] = R.param_router_init(gen, D, cfg.n_heads, device=device)
    if is_attn(kind) and spec.lora_rank:
        rp["lora"] = {
            "q": lora_init(gen, D, cfg.n_heads * cfg.d_head, spec.lora_rank,
                           device=device),
            "v": lora_init(gen, D, cfg.n_kv_heads * cfg.d_head,
                           spec.lora_rank, device=device),
        }
    if has_mlp(kind) and spec.mlp_token_routed:
        rp["tok_mlp"] = R.token_router_init(gen, D, device=device)
    n_exp = cfg.moe.n_experts if cfg.moe is not None else spec.mlp_n_experts
    if has_mlp(kind) and n_exp and spec.expert_routed:
        rp["expert"] = R.param_router_init(gen, D, n_exp, device=device)
    if spec.depth_routed:
        # drawn last, so a spec without depth draws what it drew before
        rp["depth"] = R.token_router_init(gen, D, device=device)
    return rp


# ------------------------- helpers ------------------------------------------

def _expert_args(pol, n_experts: int) -> dict:
    """moe_apply/moe_decode kwargs for the elastic expert budget: a static
    top-k keeps the small-k buffers; a tensor one sizes them for all E and
    masks (the same code and shapes for every budget)."""
    k = R.gate_topk(pol.mlp_expert_topk, pol.student, n_experts)
    if R.is_static(k):
        return {"top_k": min(int(k), n_experts)}
    return {"top_k": n_experts, "top_k_traced": k}


def _lora_gate(lora, cap, student):
    """Turn the LoRA adapters off exactly when there is nothing to rescue:
    mha token budget full, or the policy in teacher mode — budget-1.0 rows
    stay bit-lossless with trained adapters. ``cap`` is the (student-gated)
    mha token capacity or None."""
    if lora is None:
        return None
    if cap is not None:
        full = R.is_full(cap)
    elif student is None or R.is_static(student):
        full = student is not None and student <= 0
    else:
        full = student <= 0
    if R.is_static(full):
        return None if full else lora
    return {**lora, "scale": 1.0 - full.float()}


def _head_weights(rp, h, spec, pol, cfg, auxes, valid=None):
    """(B,S,H) head weights w * topk-mask; exactly 1 on full rows.
    ``valid`` keeps rows out of the load-balance statistics."""
    if rp is None or spec is None or "head" not in rp \
            or not spec.mha_head_routed:
        return None
    k = R.gate_topk(pol.mha_head_topk, pol.student, cfg.n_heads)
    w, m, a = R.param_route_weights(rp["head"], h, k, valid=valid)
    auxes.append(a)
    hw = w * m
    full = R.is_full(k, cfg.n_heads)
    if R.is_static(full):
        return torch.ones_like(hw) if full else hw
    return torch.where(R.bcast_to(full, hw.dim()), torch.ones_like(hw), hw)


def _expert_routed(rp, elastic_on, mode) -> bool:
    return bool(elastic_on and rp and "expert" in rp and mode != "base")


def _mlp_fn(p, rp, cfg, spec, pol, elastic_on, mode, auxes, backend):
    """f(h, positions[, token_valid, dispatch_frac, token_count]) for the
    MLP sub-block: a native MoE (the learned expert router when it is on,
    else the layer's own), a moefied dense MLP under the expert router, or
    the dense MLP through the fused_mlp kernel. The dense rank-masked train
    path hands in ``token_valid``/``dispatch_frac`` and the ragged plan
    path ``token_valid``/``token_count``, so skipped tokens cannot evict
    kept ones from expert capacity and the expert buffers match what a
    per-budget gather would have used."""
    def f(h, _pos, token_valid=None, dispatch_frac=None, token_count=None):
        kw = dict(act=cfg.act, token_valid=token_valid,
                  dispatch_frac=dispatch_frac, token_count=token_count,
                  backend=backend)
        routed = _expert_routed(rp, elastic_on, mode)
        if cfg.moe is not None:
            m = cfg.moe
            kw.update(capacity_factor=m.capacity_factor, seq_chunk=m.seq_chunk)
            if routed:
                y, a = moe_apply(p["mlp"], h, router_w=rp["expert"]["w"],
                                 normalize_to_m=True,
                                 **_expert_args(pol, m.n_experts), **kw)
            else:
                y, a = moe_apply(p["mlp"], h, top_k=m.top_k, **kw)
            auxes.append(a)
            return y
        if routed and spec.mlp_n_experts:
            # seq_chunk 512 bounds the (B, E, C, D) dispatch buffers
            y, a = moe_apply(moefy_mlp(p["mlp"], spec.mlp_n_experts), h,
                             router_w=rp["expert"]["w"], normalize_to_m=True,
                             seq_chunk=512,
                             **_expert_args(pol, spec.mlp_n_experts), **kw)
            auxes.append(a)
            return y
        mp = p["mlp"]
        # under a mesh the rank's F/M columns: a partial sum, completed
        return C.all_reduce_sum(OPS.fused_mlp(
            h, mp["wi"], mp["wo"], mp.get("wg"), valid_count=token_count,
            wi_scale=mp.get("wi_scale"), wo_scale=mp.get("wo_scale"),
            wg_scale=mp.get("wg_scale"), act=cfg.act, backend=backend))
    return f


def _is_dense_mlp(rp, cfg, spec, elastic_on, mode) -> bool:
    """True when the MLP sub-block is the plain dense MLP (no native MoE,
    no moefied expert routing): the case ``fused_mlp_routed`` serves."""
    if cfg.moe is not None:
        return False
    return not (_expert_routed(rp, elastic_on, mode) and spec.mlp_n_experts)


# --------------------- full-sequence block apply ----------------------------

def _as_f32(v, like):
    """A capacity as an f32 tensor on the device of ``like`` (a tensor)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _combine_caps(cap_a, cap_b):
    """Block-level plan capacity: the elementwise max of the components'
    (student-gated) token capacities; the budget solver sets them equal."""
    if cap_a is None:
        return cap_b
    if cap_b is None:
        return cap_a
    if R.is_static(cap_a) and R.is_static(cap_b):
        return max(cap_a, cap_b)
    like = cap_b if R.is_static(cap_a) else cap_a
    return torch.maximum(_as_f32(cap_a, like), _as_f32(cap_b, like))


def _mul_caps(cap_a, cap_b):
    """Multiplicative capacity composition (the depth axis): the depth
    router skips the WHOLE layer for unselected tokens, so a component's
    token fraction is its own capacity times the depth capacity, each
    clamped at 1 first (capacity >= 1 means "full", not "more")."""
    if cap_a is None:
        return cap_b
    if cap_b is None:
        return cap_a
    if R.is_static(cap_a) and R.is_static(cap_b):
        return min(1.0, cap_a) * min(1.0, cap_b)
    like = cap_b if R.is_static(cap_a) else cap_a
    return (torch.clamp(_as_f32(cap_a, like), max=1.0)
            * torch.clamp(_as_f32(cap_b, like), max=1.0))


def block_apply(kind: str, p, rp, x, *, cfg, spec, pol=None, mode: str,
                elastic_on: bool, window: int = 0, positions=None,
                causal: bool = True, collect_cache: bool = False,
                max_cache_len: int = 0, bucket=None, enc_kv=None,
                enc_valid=None):
    """x: (B,S,D) -> (x', aux[, cache]). Pre-norm residual block.

    Train mode plans the block's token routing ONCE: a ``RoutingPlan``
    (one sort) from the block's primary router: the depth router when
    depth is routed, else the mixer's token router when attention is
    routed, else the MLP's. The other routers weight the shared token set
    and BCE-train toward its membership. ``bucket`` is the static
    plan-buffer hint for tensor capacities (``policy.ragged_bucket``):
    ``IDENTITY_BUCKET`` asserts every row is at full budget (the identity
    path), ``None`` takes the dense rank-masked path (full shapes, the
    same token set). Infer mode gates each router with its threshold:
    dropped tokens are invalid keys of the attention and their outputs are
    weighted by 0; the MLP runs densely and its output is gate-weighted
    (and depth-weighted). ``causal=False``: the bidirectional stack of an
    encoder. An ``xattn`` block cross-attends to ``enc_kv`` (B, T, D) with
    ``enc_valid`` (B, T) bool or None (every row) after its attention
    residual; the cache keeps the context's K/V and ``valid``. An ``ssm`` /
    ``rglru`` block runs its mixer over the whole sequence under the
    routing's dense keep mask (the plan's membership in training) and
    weights its delta; its cache is the mixer's final {'state', 'conv'}."""
    _check_kind(kind)
    B, S, _ = x.shape
    auxes = [R.RouteAux.zero(x.device)]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    routed = elastic_on and mode != "base"
    train = mode == "train"
    backend = spec.kernel_backend if spec is not None else None
    cache = {}

    cap_mha = cap_mlp = cap_depth = None
    if routed and spec is not None and rp:
        if spec.depth_routed and "depth" in rp:
            cap_depth = R.gate_capacity(pol.depth_capacity, pol.student)
        if spec.mha_token_routed and "tok_mixer" in rp:
            cap_mha = R.gate_capacity(pol.mha_token_capacity, pol.student)
        if has_mlp(kind) and spec.mlp_token_routed and "tok_mlp" in rp:
            cap_mlp = R.gate_capacity(pol.mlp_token_capacity, pol.student)
    # depth skips the whole layer: the plan covers depth x the token caps
    cap_plan = _mul_caps(_combine_caps(cap_mha, cap_mlp), cap_depth)
    impl = spec.routing_impl if spec is not None else "gather"
    kb = None
    if train and cap_plan is not None and (
            impl == "ragged" or (impl == "gather" and R.is_static(cap_plan)
                                 and R.is_static(pol.theta))):
        kb = R.resolve_bucket(cap_plan, S, bucket, impl=impl)
    identity = kb == S              # full budget everywhere: no routing work
    k_plan = None if (kb is None or identity) else \
        R.capacity_k(cap_plan, S, mxu=True)
    plan = None                     # built by the first routed component
    dense_keep = None               # the mixer's keep on the dense path
    # mixer-stage routers, OUTERMOST first: the first builds the plan, the
    # rest weight its token set and BCE-train toward its membership
    mixer_routers = []
    if cap_depth is not None:
        mixer_routers.append(("depth", cap_depth))
    if cap_mha is not None:
        mixer_routers.append(("tok_mixer", cap_mha))
    depth = {}                      # "scores" (dense), "w_sel" (plan), "w"

    def bce_aux(logits, keep):
        auxes.append(R.RouteAux.of(topk=R.bce_topk_loss(logits, keep),
                                   keep=keep))

    def gate(name, h_src):
        logits = R.token_logits(rp[name], h_src)
        return logits, torch.sigmoid(logits)

    def build_plan(h_src):
        """The block's ONE sort, on its primary router."""
        name = mixer_routers[0][0] if mixer_routers else "tok_mlp"
        logits, scores = gate(name, h_src)
        return R.make_plan(scores, k_plan, kb), logits, scores

    def plan_weights(plan, logits, scores, h_src):
        """Mixer-stage weight on the plan's selected set: the primary
        router's scores times every secondary mixer router's."""
        w_sel = R.gather_tokens(scores, plan.idx)
        bce_aux(logits, plan.keep)
        if mixer_routers[0][0] == "depth":
            depth["w_sel"] = w_sel * plan.valid
        for name, _c in mixer_routers[1:]:
            lg, sc = gate(name, h_src)
            w_sel = w_sel * R.gather_tokens(sc, plan.idx)
            bce_aux(lg, plan.keep)
        return w_sel * plan.valid

    def mixer_gate(h_src):
        """Dense / threshold gate over every mixer-stage router. Train: the
        primary router rank-masks at the plan capacity, the others weigh
        in. Infer: each router thresholds at theta; keeps AND, weights
        multiply (the decode gate's rule)."""
        name0 = mixer_routers[0][0]
        logits, scores = gate(name0, h_src)
        if name0 == "depth":
            depth["scores"] = scores
        if train:
            keep, wtok = R.token_gate(logits, scores, cap_plan, mode,
                                      theta=pol.theta, mxu=True)
            bce_aux(logits, keep)
            full = R.is_full(cap_plan)
            for name, _c in mixer_routers[1:]:
                lg, sc = gate(name, h_src)
                if R.is_static(full):
                    wtok = wtok if full else wtok * sc
                else:
                    wtok = wtok * torch.where(R.bcast_to(full, keep.dim()),
                                              torch.ones_like(sc), sc)
                bce_aux(lg, keep)
            return keep, wtok
        keep = wtok = None
        for name, c in mixer_routers:
            lg, sc = (logits, scores) if name == name0 else gate(name, h_src)
            kp, w = R.token_gate(lg, sc, c, mode, theta=pol.theta, mxu=True)
            auxes.append(R.RouteAux.of(keep=kp))
            if name == "depth":
                depth["w"] = w
            keep = kp if keep is None else keep & kp
            wtok = w if wtok is None else wtok * w
        return keep, wtok

    # ---- the temporal mixer: attention or a recurrence ----
    h = norm_apply(p["norm1"], x, cfg.norm)
    if is_attn(kind):
        lora = rp.get("lora") if (routed and rp) else None
        lora = _lora_gate(lora, _mul_caps(cap_mha, cap_depth),
                          pol.student if (routed and pol is not None)
                          else None)

        def attn(hh, pos, **kw):
            return A.attn_apply(p["attn"], hh, cfg=cfg, positions=pos,
                                causal=causal, window=window, lora=lora,
                                backend=backend, **kw)

        if not mixer_routers:
            hw = _head_weights(rp, h, spec, pol, cfg, auxes) if routed \
                else None
            y, k, v = attn(h, positions, head_weights=hw)
            delta = y
            keep = torch.ones((B, S), dtype=torch.bool, device=x.device)
        elif identity:
            keep = torch.ones((B, S), dtype=torch.bool, device=x.device)
            for name, _c in mixer_routers:
                bce_aux(gate(name, h)[0], keep)
            hw = _head_weights(rp, h, spec, pol, cfg, auxes)
            y, k, v = attn(h, positions, head_weights=hw)
            delta = y
        elif kb is not None:
            # the shared plan: selected tokens gathered valid-first (a
            # position-ascending prefix of the bucket), the tail masked;
            # with depth routed it is the depth router's selection
            plan, logits, scores = build_plan(h)
            h_sel = R.plan_gather(h, plan)
            pos_sel = R.gather_tokens(positions.expand(B, S), plan.idx)
            hw = _head_weights(rp, h_sel, spec, pol, cfg, auxes,
                               valid=plan.valid)
            y_sel, k, v = attn(h_sel, pos_sel, kv_valid=plan.valid,
                               kv_count=plan.count, head_weights=hw,
                               gathered=True)
            w_sel = plan_weights(plan, logits, scores, h)
            delta = R.plan_scatter(
                plan, x, y_sel * w_sel[..., None].to(y_sel.dtype))
            keep = plan.keep
            if collect_cache:       # the plan's k/v back at full positions
                k = _scatter_kv(k, plan.idx, S)
                v = _scatter_kv(v, plan.idx, S)
        else:                       # threshold (infer) or dense train path
            keep, wtok = mixer_gate(h)
            if train:
                dense_keep = keep
            # head-router statistics over the selected tokens in training,
            # as on the plan path (whose buffer holds exactly the selected
            # set)
            hw = _head_weights(rp, h, spec, pol, cfg, auxes,
                               valid=keep if train else None)
            y, k, v = attn(h, positions, kv_valid=keep, head_weights=hw)
            delta = y * wtok[..., None].to(y.dtype)
        if collect_cache:
            cache["attn"] = _pad_cache(
                k, v, keep, max_cache_len or S, window,
                kv_dtype=spec.kv_dtype if spec is not None else "fp32")
    else:                           # ssm / rglru: a dense keep mask
        keep = wtok = None
        if mixer_routers and identity:
            ones = torch.ones((B, S), dtype=torch.bool, device=x.device)
            for name, _c in mixer_routers:
                bce_aux(gate(name, h)[0], ones)
        elif mixer_routers and kb is not None:
            # a recurrence cannot run on a gathered subset: the mixer takes
            # the shared plan's MEMBERSHIP as its mask
            plan, logits, scores = build_plan(h)
            keep = plan.keep
            if mixer_routers[0][0] == "depth":
                depth["w_sel"] = R.gather_tokens(scores, plan.idx) * \
                    plan.valid
            wtok = keep * scores
            bce_aux(logits, keep)
            for name, _c in mixer_routers[1:]:
                lg, sc = gate(name, h)
                wtok = wtok * sc
                bce_aux(lg, keep)
        elif mixer_routers:         # threshold (infer) or dense train path
            keep, wtok = mixer_gate(h)
            if train:
                dense_keep = keep
        mixer = SSM.ssm_apply if kind == "ssm" else G.rglru_apply
        y, (st, cv) = mixer(p["mixer"], h, cfg, keep_mask=keep)
        if collect_cache:
            cache[kind] = {"state": st, "conv": cv}
        delta = y if keep is None else y * wtok[..., None].to(y.dtype)
    x = x + delta

    # ---- cross-attention ----
    if kind == "xattn":
        hx = norm_apply(p["xnorm"], x, cfg.norm)
        y, xk, xv = A.attn_apply(p["xattn"], hx, cfg=cfg, positions=positions,
                                 kv_x=enc_kv, kv_valid=enc_valid,
                                 backend=backend)
        x = x + y
        if collect_cache:
            ev = (torch.ones(enc_kv.shape[:2], dtype=torch.bool,
                             device=x.device) if enc_valid is None
                  else enc_valid.expand(enc_kv.shape[:2]))
            cache["xattn"] = {"k": xk, "v": xv, "valid": ev}

    # ---- MLP (none in an ssm block) ----
    if has_mlp(kind):
        h = norm_apply(p["norm2"], x, cfg.norm)
        f = _mlp_fn(p, rp, cfg, spec, pol, elastic_on, mode, auxes, backend)
        if cap_mlp is None and cap_depth is None:
            delta = f(h, positions)
        elif identity:
            if cap_mlp is not None:
                bce_aux(gate("tok_mlp", h)[0],
                        torch.ones((B, S), dtype=torch.bool, device=x.device))
            delta = f(h, positions)
        elif kb is not None:
            if plan is None:            # the block's one sort, on this router
                plan, logits, scores = build_plan(h)
                w_sel = R.gather_tokens(scores, plan.idx) * plan.valid
                bce_aux(logits, plan.keep)
            else:
                if cap_mlp is not None:
                    logits, scores = gate("tok_mlp", h)
                    w_sel = R.gather_tokens(scores, plan.idx) * plan.valid
                    bce_aux(logits, plan.keep)
                else:
                    w_sel = plan.valid.float()
                if "w_sel" in depth:    # the whole delta is depth-gated
                    w_sel = w_sel * depth["w_sel"]
            if _is_dense_mlp(rp, cfg, spec, elastic_on, mode):
                # The routed kernel gathers the plan's rows from h and
                # scatters the weighted outputs back. The JAX package gates
                # its TPU kernel on a resident (S, D) VMEM slab
                # (ROUTED_MLP_SLAB_BYTES); the Hopper kernel keeps no such
                # slab, so every dense-MLP plan takes it on the card (the
                # plain version on the CPU: the same math as the gather +
                # fused_mlp branch there).
                # Under a mesh every rank runs its F/M columns on the
                # same plan and the partial deltas are all-reduced (the
                # JAX package's fused_mlp_routed_sharded).
                mp = p["mlp"]
                delta = C.all_reduce_sum(OPS.fused_mlp_routed(
                    h, plan.idx, mp["wi"], mp["wo"], mp.get("wg"), w_sel,
                    valid_count=plan.count, wi_scale=mp.get("wi_scale"),
                    wo_scale=mp.get("wo_scale"), wg_scale=mp.get("wg_scale"),
                    act=cfg.act, backend=backend))
            else:                       # expert layers: the bucket buffer
                y_sel = f(R.plan_gather(h, plan), None, token_valid=plan.valid,
                          token_count=plan.count)
                delta = R.plan_scatter(
                    plan, x, y_sel * w_sel[..., None].to(y_sel.dtype))
        elif train:                     # dense train path
            logits = scores = None
            if cap_mlp is not None:
                logits, scores = gate("tok_mlp", h)
            if dense_keep is not None:  # the mixer's selection is the block's
                keep = dense_keep
                w = keep.float()
                if scores is not None:
                    w = w * scores
                if "scores" in depth:
                    w = w * depth["scores"]
                full = R.is_full(cap_plan)
                if R.is_static(full):
                    wtok = torch.ones_like(w) if full else w
                else:
                    wtok = torch.where(R.bcast_to(full, keep.dim()),
                                       torch.ones_like(w), w)
            else:
                keep, wtok = R.token_gate(logits, scores, cap_plan, mode,
                                          theta=pol.theta, mxu=True)
            y = f(h, positions, token_valid=keep, dispatch_frac=cap_plan)
            delta = y * wtok[..., None].to(y.dtype)
            if logits is not None:
                bce_aux(logits, keep)
        else:                           # inference threshold (§B.1)
            if cap_mlp is None:
                delta = f(h, positions)
            else:
                delta, a = R.route_tokens(rp["tok_mlp"], h, f, cap_mlp, mode,
                                          positions=positions, theta=pol.theta)
                auxes.append(a)
            if "w" in depth:            # the depth gate covers the MLP too
                delta = delta * depth["w"][..., None].to(delta.dtype)
        x = x + delta

    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    return (x, aux, cache) if collect_cache else (x, aux)


def _scatter_kv(t, idx, s: int):
    """A plan's (B, bucket, K, Dh) k or v rows back at their positions of
    a (B, s, K, Dh) tensor, zeros elsewhere: buffer row i goes to position
    idx[b, i] (no duplicates in a row), the masked tail included, as the
    JAX package scatters it; ``keep`` marks the live ones."""
    out = t.new_zeros((t.shape[0], s) + tuple(t.shape[2:]))
    bi = torch.arange(t.shape[0], device=t.device)[:, None]
    out[bi, idx] = t
    return out


def _pad_cache(k, v, keep, max_len: int, window: int = 0,
               kv_dtype: str = "fp32") -> dict:
    """Lay prefill k/v into the ring-cache format (slot = pos % L).

    ``kv_dtype`` "int8" quantizes here, the ring's one-shot-prefill WRITE
    site: the codes a later decode reads are what a decode-time write of
    the same token would have stored (the prefill's own attention ran on
    the unquantized k/v, as in the JAX package); unwritten slots keep
    scale 1.0. "bf16" narrows at the row splice (``cache_row_insert``)."""
    B, S = k.shape[:2]
    L = min(max_len, window) if window and window > 0 else max_len
    dev = k.device
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    rows = {"k": k, "v": v}
    if kv_dtype == "int8":
        (rows["k"], rows["kscale"]), (rows["v"], rows["vscale"]) = \
            Q.quantize_kv(k), Q.quantize_kv(v)
    # an unwritten slot: zero codes, scale 1.0
    blank = lambda name, a, shape: torch.full(
        shape, 1.0 if name.endswith("scale") else 0, dtype=a.dtype,
        device=dev)
    if S <= L:
        out = {}
        for name, a in rows.items():
            out[name] = blank(name, a, (B, L) + a.shape[2:])
            out[name][:, :S] = a
        out["valid"] = torch.zeros((B, L), dtype=torch.bool, device=dev)
        out["valid"][:, :S] = keep
        out["pos"] = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        out["pos"][:, :S] = pos
        return out
    # keep the last L positions, at their ring slots
    keep, pos = keep[:, -L:], pos[:, -L:]
    slots = (pos % L).long()
    bi = torch.arange(B, device=dev)[:, None]
    out = {}
    for name, a in rows.items():
        a = a[:, -L:]
        out[name] = blank(name, a, a.shape)
        out[name][bi, slots] = a
    out["valid"] = torch.zeros_like(keep)
    out["valid"][bi, slots] = keep
    out["pos"] = torch.full_like(pos, -1)
    out["pos"][bi, slots] = pos
    return out


# ------------------------------ decode --------------------------------------

def _decode_token_gate(rp, name, h, cap, pol):
    """Threshold gate for one decode token: (keep (B,), weight (B,)).
    capacity >= 1 or student off forces (keep all, weight 1) per row."""
    logits = R.token_logits(rp[name], h)[:, 0]
    keep = logits > R.threshold_logit(pol.theta)
    w = keep * torch.sigmoid(logits)
    full = R.is_full(R.gate_capacity(cap, pol.student))
    if R.is_static(full):
        if full:
            return torch.ones_like(keep), torch.ones_like(w)
        return keep, w
    full = full.expand(keep.shape)
    return keep | full, torch.where(full, torch.ones_like(w), w)


def block_decode(kind: str, p, rp, x, cache, t, *, cfg, spec, pol=None,
                 mode: str, elastic_on: bool, window: int = 0, table=None,
                 trash=None):
    """One token per row. x: (B,1,D); the cache is updated in place.
    ``table``/``trash``: the paged-KV operands (the (B, P) page-table rows
    and (B,) per-slot trash pages, see ``attention.attn_decode_paged``);
    given them, the cache is a page pool ({'kp','vp','pvalid'}) and
    attention appends through the page table instead of the ring. The
    depth gate is per (slot, layer): a skipped token writes no K/V at this
    layer (the ring's ``valid`` / the pool's ``pvalid`` records the hole)
    and its attention and MLP deltas are weighted by 0. Returns (x',
    cache). An ``xattn`` block then cross-attends to its slot's context
    cache (``attention.cross_attn_decode``). An ``ssm`` / ``rglru`` block
    steps its recurrence with the gate as ``write`` (a skipped token leaves
    the state and conv rows as they were) and copies the new state and
    conv rows into its cache's tensors in place, which a captured decode
    graph reads."""
    _check_kind(kind)
    routed = elastic_on and mode != "base" and rp is not None
    backend = spec.kernel_backend if spec is not None else None

    h = norm_apply(p["norm1"], x, cfg.norm)
    keepd, wd = None, None
    if routed and spec.depth_routed and "depth" in rp:
        keepd, wd = _decode_token_gate(rp, "depth", h, pol.depth_capacity,
                                       pol)
    keep, w1 = None, None
    if routed and spec.mha_token_routed and "tok_mixer" in rp:
        keep, w1 = _decode_token_gate(rp, "tok_mixer", h,
                                      pol.mha_token_capacity, pol)
    if keepd is not None:
        keep = keepd if keep is None else keep & keepd
        w1 = wd if w1 is None else w1 * wd
    if is_attn(kind):
        lora = rp.get("lora") if routed else None
        if lora is not None:
            dcap = R.gate_capacity(pol.mha_token_capacity, pol.student) \
                if spec.mha_token_routed else None
            dcap = _mul_caps(dcap, R.gate_capacity(pol.depth_capacity,
                                                   pol.student)
                             if spec.depth_routed else None)
            lora = _lora_gate(lora, dcap, pol.student)
        hw = _head_weights(rp, h, spec, pol, cfg, []) if routed else None
        if table is not None:
            y, cache["attn"] = A.attn_decode_paged(
                p["attn"], h, cache["attn"], t, table, trash, cfg=cfg,
                head_weights=hw, lora=lora, write=keep, backend=backend)
        else:
            y, cache["attn"] = A.attn_decode(
                p["attn"], h, cache["attn"], t, cfg=cfg, window=window,
                head_weights=hw, lora=lora, write=keep, backend=backend)
    else:
        step = SSM.ssm_decode if kind == "ssm" else G.rglru_decode
        y, new = step(p["mixer"], h, cache[kind], cfg, write=keep)
        for name, leaf in cache[kind].items():
            leaf.copy_(new[name])
    if keep is not None:
        y = y * w1[:, None, None].to(y.dtype)
    x = x + y
    if kind == "xattn":
        x = x + A.cross_attn_decode(
            p["xattn"], norm_apply(p["xnorm"], x, cfg.norm), cache["xattn"],
            cfg=cfg)
    if not has_mlp(kind):
        return x, cache

    h = norm_apply(p["norm2"], x, cfg.norm)
    keep2, w2 = None, None
    if routed and spec.mlp_token_routed and "tok_mlp" in rp:
        keep2, w2 = _decode_token_gate(rp, "tok_mlp", h,
                                       pol.mlp_token_capacity, pol)
    if keepd is not None:           # depth gates the MLP delta too
        keep2 = keepd if keep2 is None else keep2 & keepd
        w2 = wd if w2 is None else w2 * wd
    if cfg.moe is not None:
        if routed and "expert" in rp:
            y, _ = moe_decode(p["mlp"], h, act=cfg.act,
                              router_w=rp["expert"]["w"], normalize_to_m=True,
                              **_expert_args(pol, cfg.moe.n_experts))
        else:
            y, _ = moe_decode(p["mlp"], h, act=cfg.act, top_k=cfg.moe.top_k)
    elif routed and "expert" in rp and spec.mlp_n_experts:
        y, _ = moe_decode(moefy_mlp(p["mlp"], spec.mlp_n_experts), h,
                          act=cfg.act, router_w=rp["expert"]["w"],
                          normalize_to_m=True,
                          **_expert_args(pol, spec.mlp_n_experts))
    else:
        y = C.all_reduce_sum(mlp_apply(p["mlp"], h, cfg.act))
    if keep2 is not None:
        y = y * w2[:, None, None].to(y.dtype)
    return x + y, cache


def block_chunk(kind: str, p, rp, x, cache, write_page, table_row, pos0,
                plen, *, cfg, spec, pol=None, mode: str, elastic_on: bool):
    """One CHUNK of a paged prefill: x is (1, C, D) with C == page_size,
    covering absolute positions [pos0, pos0 + C) of a plen-token prompt
    (the last chunk arrives zero-padded). The inference-threshold branch of
    ``block_apply``: the token and depth gates, head routing and LoRA
    gating are all per token, so streaming a prompt through this chunk by
    chunk takes the one-shot prefill's keep decisions; K/V go into ONE
    pool page (``write_page``; a token the depth router skips leaves a
    ``pvalid`` hole) and attention reads through ``table_row`` (see
    ``attention.attn_chunk``). ``write_page``, ``pos0`` and ``plen``:
    Python ints or 0-d int device tensors. Paged serving runs dense MLPs
    only (the engine validates it). Returns (x', cache)."""
    if mode not in ("infer", "base"):
        raise ValueError(f"block_chunk serves infer/base modes, got {mode!r}")
    _paged_kind(kind)
    routed = elastic_on and mode != "base" and rp is not None
    backend = spec.kernel_backend if spec is not None else None
    positions = pos0 + torch.arange(x.shape[1], dtype=torch.int32,
                                    device=x.device)              # (C,)

    cap_mha = cap_mlp = cap_depth = None
    if routed and spec is not None and rp:
        if spec.depth_routed and "depth" in rp:
            cap_depth = R.gate_capacity(pol.depth_capacity, pol.student)
        if spec.mha_token_routed and "tok_mixer" in rp:
            cap_mha = R.gate_capacity(pol.mha_token_capacity, pol.student)
        if spec.mlp_token_routed and "tok_mlp" in rp:
            cap_mlp = R.gate_capacity(pol.mlp_token_capacity, pol.student)

    # ---- attention (one page written, the table row attended) ----
    h = norm_apply(p["norm1"], x, cfg.norm)
    lora = rp.get("lora") if routed else None
    lora = _lora_gate(lora, _mul_caps(cap_mha, cap_depth),
                      pol.student if (routed and pol is not None) else None)
    hw = _head_weights(rp, h, spec, pol, cfg, []) if routed else None
    keep_d, w_d = None, None
    if cap_depth is not None:
        lg = R.token_logits(rp["depth"], h)
        keep_d, w_d = R.token_gate(lg, torch.sigmoid(lg), cap_depth, mode,
                                   theta=pol.theta, mxu=True)
    keep, wtok = None, None
    if cap_mha is not None:
        logits = R.token_logits(rp["tok_mixer"], h)
        keep, wtok = R.token_gate(logits, torch.sigmoid(logits), cap_mha,
                                  mode, theta=pol.theta, mxu=True)
    if keep_d is not None:
        keep = keep_d if keep is None else keep & keep_d
        wtok = w_d if wtok is None else wtok * w_d
    y, cache["attn"] = A.attn_chunk(
        p["attn"], h, cache["attn"], write_page, table_row, pos0, plen,
        cfg=cfg, keep=keep, head_weights=hw, lora=lora, backend=backend)
    if wtok is not None:
        y = y * wtok[..., None].to(y.dtype)
    x = x + y

    # ---- MLP (dense, per-token threshold routing) ----
    h = norm_apply(p["norm2"], x, cfg.norm)
    f = _mlp_fn(p, rp, cfg, spec, pol, elastic_on, mode, [], backend)
    if cap_mlp is None:
        delta = f(h, positions)
    else:
        delta, _ = R.route_tokens(rp["tok_mlp"], h, f, cap_mlp, mode,
                                  positions=positions, theta=pol.theta)
    if w_d is not None:             # depth gates the MLP delta too
        delta = delta * w_d[..., None].to(delta.dtype)
    return x + delta, cache


def block_paged_cache_init(kind: str, cfg, n_pages: int, page_size: int,
                           device=None, kv_dtype: str = "fp32") -> dict:
    """Paged twin of ``block_cache_init``: one layer's slice of the global
    page pool."""
    _paged_kind(kind)
    return {"attn": A.attn_paged_cache_init(cfg, n_pages, page_size,
                                            device=device,
                                            kv_dtype=kv_dtype)}


def cache_row_insert(full: dict, row: dict, slot: int) -> None:
    """Copy a single-request block cache (batch dim 1) into row ``slot`` of
    a live slot-array cache, in place. int8 codes and their scale leaves
    move verbatim; a bf16 cache narrows the prefill's k/v here."""
    for name, leaf in full.items():
        if isinstance(leaf, dict):
            cache_row_insert(leaf, row[name], slot)
        else:
            leaf[slot] = row[name][0].to(leaf.dtype)


def _paged_kind(kind: str) -> None:
    """The paged layout serves self-attention blocks only, as in the JAX
    package (a cross-attention context and a recurrent state have no page
    form)."""
    if kind != "attn":
        raise ValueError(f"paged KV cache requires self-attention blocks, "
                         f"got {kind!r}")


def block_cache_init(kind: str, cfg, batch: int, max_seq: int,
                     enc_len: int = 0, window: int = 0, device=None,
                     kv_dtype: str = "fp32") -> dict:
    """One layer's ring cache (a windowed layer's ring holds min(max_seq,
    window) slots); an ``xattn`` layer adds its context cache {'k','v':
    (batch, enc_len, K, Dh) in the config dtype, 'valid'}, which each
    admission overwrites with its request's context; an ``ssm`` /
    ``rglru`` layer has its recurrent cache {'state', 'conv'} instead."""
    _check_kind(kind)
    if kind == "ssm":
        return {"ssm": SSM.ssm_cache_init(cfg, batch, device=device)}
    if kind == "rglru":
        return {"rglru": G.rglru_cache_init(cfg, batch, device=device)}
    c = {"attn": A.attn_cache_init(cfg, batch, max_seq, window,
                                   device=device, kv_dtype=kv_dtype)}
    if kind == "xattn":
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        c["xattn"] = {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "valid": torch.zeros((batch, enc_len), dtype=torch.bool,
                                 device=device)}
    return c
