"""ElasticSpec / ElasticPolicy: one model, many compute budgets.

* ``ElasticSpec`` — static description of which elastic machinery exists
  (routers, LoRA rank, layers, kernel backend). Frozen and hashable.
* ``ElasticPolicy`` — runtime knobs: token capacities, head/expert top-k,
  the decode threshold theta and a teacher/student flag. Leaves are Python
  numbers (static: trace-time constants in the JAX package) or float32
  tensors of shape ``()``, ``(B,)`` (one leaf per serving slot) or
  ``(L, 1)`` / ``(L, B)`` (per-layer schedules, ``for_layer``).

Budget semantics: any capacity ``>= 1`` (or top-k ``>= n``) is the exact
frozen-teacher computation, so ``ElasticPolicy.uniform(1.0)`` reproduces
the teacher bit for bit. ``solve_budget`` maps a FLOP budget to a policy
with the JAX package's analytic roofline model.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

FULL_TOPK = 1 << 30   # a top-k meaning "all submodules"

Scalar = Union[float, int, torch.Tensor]


@dataclass(frozen=True)
class ElasticSpec:
    """What elastic machinery exists (shapes the params; static)."""
    mlp_token_routed: bool = True
    mha_token_routed: bool = False
    mha_head_routed: bool = False
    depth_routed: bool = False
    mlp_n_experts: Optional[int] = None
    expert_routed: bool = False
    vlm_routed: bool = False
    vlm_router: str = "linear"
    vlm_router_hidden: int = 0
    lora_rank: int = 0
    layers: str = "all"                # all | even  (paper §5.2)
    router_dtype: str = "float32"
    distill_loss: str = "topk_kl"
    distill_topk: int = 50
    distill_temp: float = 1.0
    lambda_load: float = 1.0
    lambda_topk: float = 1.0
    routing_impl: str = "ragged"
    # auto = kernels on CUDA tensors, plain versions on CPU ones; cuda =
    # kernels only; ref = plain versions (see kernels/ops.py)
    kernel_backend: str = "auto"
    kv_dtype: str = "fp32"             # fp32 | bf16 | int8 (models/quant.py)
    weight_dtype: str = "fp32"         # fp32 | bf16 | int8

    def __post_init__(self):
        from repro_torch.models.quant import (check_kv_dtype,
                                              check_weight_dtype)
        check_kv_dtype(self.kv_dtype)
        check_weight_dtype(self.weight_dtype)

    def applies_to_layer(self, idx: int) -> bool:
        return self.layers == "all" or idx % 2 == 0


def _leaf(v, static: bool):
    return v if static else torch.tensor(float(v), dtype=torch.float32)


def _map(fn, *pols: "ElasticPolicy") -> "ElasticPolicy":
    """Apply fn leaf-wise over policies of the same structure."""
    return ElasticPolicy(**{
        f.name: fn(*(getattr(p, f.name) for p in pols))
        for f in dataclasses.fields(ElasticPolicy)})


@dataclass
class ElasticPolicy:
    """Runtime compute budget. Capacities are fractions in (0, 1]; top-k
    values are absolute counts (``FULL_TOPK`` = all). ``student <= 0``
    disables all routing (exact teacher), per slot when shaped (B,)."""
    mlp_token_capacity: Scalar = 1.0
    mha_token_capacity: Scalar = 1.0
    depth_capacity: Scalar = 1.0
    mha_head_topk: Scalar = FULL_TOPK
    mlp_expert_topk: Scalar = FULL_TOPK
    vlm_token_capacity: Scalar = 1.0
    theta: Scalar = 0.5
    student: Scalar = 1.0

    @classmethod
    def uniform(cls, budget: float, *, n_heads: Optional[int] = None,
                n_experts: Optional[int] = None, theta: float = 0.5,
                static: bool = False) -> "ElasticPolicy":
        """Same fractional budget on every knob; head/expert top-k resolved
        when the counts are given, else left at "all"."""
        topk = lambda n: (max(1, min(n, int(math.ceil(budget * n - 1e-9))))
                          if n else FULL_TOPK)
        return cls(
            mlp_token_capacity=_leaf(budget, static),
            mha_token_capacity=_leaf(budget, static),
            depth_capacity=_leaf(budget, static),
            mha_head_topk=_leaf(topk(n_heads), static),
            mlp_expert_topk=_leaf(topk(n_experts), static),
            vlm_token_capacity=_leaf(budget, static),
            theta=_leaf(theta, static),
            student=_leaf(1.0, static),
        )

    @classmethod
    def teacher(cls, *, static: bool = False) -> "ElasticPolicy":
        """Exact frozen-teacher pass-through (routers bypassed)."""
        return cls.uniform(1.0, static=static).replace(
            student=_leaf(0.0, static))

    @classmethod
    def stack(cls, policies: Sequence["ElasticPolicy"]) -> "ElasticPolicy":
        """Batch per-request policies into one: every leaf becomes (B,)."""
        return _map(lambda *ls: torch.stack(
            [torch.as_tensor(l, dtype=torch.float32) for l in ls]), *policies)

    def to(self, device) -> "ElasticPolicy":
        """Tensor leaves (static ones become f32 tensors) on ``device``."""
        return _map(lambda v: torch.as_tensor(v, dtype=torch.float32)
                    .to(device), self)

    def broadcast_rows(self, batch: int) -> "ElasticPolicy":
        """Every leaf as a fresh (B,) float32 tensor: the live slot policy a
        continuous-batching engine splices admissions into."""
        return _map(lambda v: torch.as_tensor(v, dtype=torch.float32)
                    .expand(batch).clone(), self)

    def clamp_capacities(self, floor: float) -> "ElasticPolicy":
        """Every capacity fraction bounded below by ``floor`` (in (0, 1]),
        as float32 tensors. The SLO controller's degradation stages go
        through this so a misconfigured or runaway controller can never
        drive a live row to a vanishing capacity; top-k leaves already
        floor at 1 in the roofline solver and ``theta``/``student`` are
        not budgets."""
        clamp = lambda v: torch.clamp(
            torch.as_tensor(v, dtype=torch.float32), min=float(floor))
        return self.replace(
            mlp_token_capacity=clamp(self.mlp_token_capacity),
            mha_token_capacity=clamp(self.mha_token_capacity),
            depth_capacity=clamp(self.depth_capacity),
            vlm_token_capacity=clamp(self.vlm_token_capacity))

    def set_row(self, i: int, row: "ElasticPolicy") -> "ElasticPolicy":
        """A copy of this (B,)- or (L, B)-leaf policy with slot ``i`` set to
        ``row``'s leaves: the JAX package's functional update, which leaves
        the caller's policy as it was (model-level callers and tests). The
        serving engine splices in place (``set_row_``)."""
        return self.replace(**{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)}).set_row_(i, row)

    def set_row_(self, i: int, row: "ElasticPolicy", *,
                 floor: Optional[float] = None) -> "ElasticPolicy":
        """Slot ``i`` of this (B,)- or (L, B)-leaf policy set to ``row``'s
        leaves (scalars, or (L, 1) / (L,) per-layer rows) IN PLACE: the
        serving engine's admission, fork and in-flight degradation splice.
        Every leaf keeps its storage, so a captured decode step that reads
        the leaves sees the new row. ``floor`` (optional) bounds the row's
        capacities from below first (``clamp_capacities``), the
        degradation path's safety rail. Returns self."""
        if floor is not None:
            row = row.clamp_capacities(floor)
        for f in dataclasses.fields(self):
            live = getattr(self, f.name)
            r = torch.as_tensor(getattr(row, f.name), dtype=torch.float32,
                                device=live.device)
            if r.dim() and r.dim() == live.dim():     # (L, 1): one row
                r = r[..., 0]
            live[..., i] = r
        return self

    def copy_(self, src: "ElasticPolicy") -> "ElasticPolicy":
        """Every tensor leaf of this policy overwritten in place with
        ``src``'s leaf of the same shape (the serving engine's static
        policy of the captured prefill chunk). Returns self."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(torch.as_tensor(
                getattr(src, f.name), dtype=torch.float32))
        return self

    # ---- per-layer schedules ----
    @property
    def has_layer_dim(self) -> bool:
        """True when some leaf is ``(L, ...)`` (ndim >= 2): a per-layer
        schedule."""
        return any(getattr(getattr(self, f.name), "ndim", 0) >= 2
                   for f in dataclasses.fields(self))

    def for_layer(self, i: int) -> "ElasticPolicy":
        """Layer ``i``'s policy: ``v[i % L]`` of every ``(L, ...)`` leaf;
        scalar and ``(B,)`` leaves pass through."""
        return _map(lambda v: v[i % v.shape[0]]
                    if getattr(v, "ndim", 0) >= 2 else v, self)

    def replace(self, **kw) -> "ElasticPolicy":
        return dataclasses.replace(self, **kw)


# ------------------------ legacy ElasticConfig shim ---------------------------

def spec_from_config(ecfg) -> ElasticSpec:
    """Map a legacy ``ElasticConfig`` onto the static half of the API."""
    return ElasticSpec(
        mlp_token_routed=ecfg.mlp_token_capacity is not None,
        mha_token_routed=ecfg.mha_token_capacity is not None,
        mha_head_routed=ecfg.mha_head_topk is not None,
        depth_routed=ecfg.depth_capacity is not None,
        mlp_n_experts=ecfg.mlp_n_experts,
        expert_routed=bool(ecfg.mlp_expert_topk),
        vlm_routed=ecfg.vlm_token_capacity is not None,
        vlm_router=ecfg.vlm_router,
        vlm_router_hidden=ecfg.vlm_router_hidden,
        lora_rank=ecfg.lora_rank,
        layers=ecfg.layers,
        router_dtype=ecfg.router_dtype,
        distill_loss=ecfg.distill_loss,
        distill_topk=ecfg.distill_topk,
        distill_temp=ecfg.distill_temp,
        lambda_load=ecfg.lambda_load,
        lambda_topk=ecfg.lambda_topk,
        routing_impl=ecfg.routing_impl,
        kernel_backend=ecfg.kernel_backend,
        kv_dtype=ecfg.kv_dtype,
        weight_dtype=ecfg.weight_dtype,
    )


def policy_from_config(ecfg) -> ElasticPolicy:
    """Runtime half of the shim: static (Python-number) leaves."""
    return ElasticPolicy(
        mlp_token_capacity=(1.0 if ecfg.mlp_token_capacity is None
                            else float(ecfg.mlp_token_capacity)),
        mha_token_capacity=(1.0 if ecfg.mha_token_capacity is None
                            else float(ecfg.mha_token_capacity)),
        depth_capacity=(1.0 if ecfg.depth_capacity is None
                        else float(ecfg.depth_capacity)),
        mha_head_topk=(FULL_TOPK if ecfg.mha_head_topk is None
                       else int(ecfg.mha_head_topk)),
        mlp_expert_topk=(FULL_TOPK if not ecfg.mlp_expert_topk
                         else int(ecfg.mlp_expert_topk)),
        vlm_token_capacity=(1.0 if ecfg.vlm_token_capacity is None
                            else float(ecfg.vlm_token_capacity)),
        theta=0.5,
        student=1.0,
    )


def as_spec_policy(elastic, policy: Optional[ElasticPolicy] = None):
    """Coerce ``ElasticConfig | ElasticSpec | None`` (+ optional policy)
    into a (spec, policy) pair."""
    if elastic is None:
        return None, None
    if isinstance(elastic, ElasticSpec):
        return elastic, (policy if policy is not None
                         else ElasticPolicy.uniform(1.0, static=True))
    spec = spec_from_config(elastic)
    return spec, (policy if policy is not None else policy_from_config(elastic))


# ----------------------- ragged bucket resolution ----------------------------

def ragged_bucket(policy: Optional[ElasticPolicy], s: int,
                  *, n_buckets: Optional[int] = None,
                  align: Optional[int] = None,
                  spec: Optional[ElasticSpec] = None) -> Optional[int]:
    """Host-side bucket solver: the smallest static capacity bucket that
    covers the policy's token capacities at sequence length ``s``, to pass
    as ``bucket=`` beside a tensor policy. Returns a bucket ``b < s``;
    ``routing.IDENTITY_BUCKET`` when every row is at full budget (or in
    teacher mode), so the identity path runs; or ``None`` when rows mix
    full and partial budgets or the covering bucket would be the whole
    sequence (the dense rank-masked path). With ``spec``, knobs that are
    not routed drop out and depth composes multiplicatively."""
    from repro_torch.core import routing as R
    if policy is None:
        return None
    vals = [torch.as_tensor(c, dtype=torch.float32) for c in (
        policy.mha_token_capacity, policy.mlp_token_capacity,
        policy.student, policy.depth_capacity)]
    if spec is not None:
        one = torch.ones((), dtype=torch.float32, device=vals[0].device)
        cap_rows = torch.maximum(
            vals[0] if spec.mha_token_routed else one,
            vals[1] if spec.mlp_token_routed else one)
        if spec.depth_routed:
            cap_rows = cap_rows * torch.clamp(vals[3], max=1.0)
    else:
        cap_rows = torch.maximum(vals[0], vals[1])
    eff = torch.where(vals[2] <= 0.0, torch.ones_like(cap_rows), cap_rows)
    if float(eff.min()) >= 1.0:
        return R.IDENTITY_BUCKET
    if float(eff.max()) >= 1.0:
        return None
    kw = {}
    if n_buckets is not None:
        kw["n_buckets"] = n_buckets
    if align is not None:
        kw["align"] = align
    b = R.bucket_for(R.capacity_k(float(eff.max()), s, mxu=True), s, **kw)
    return b if b < s else None


# ------------------------- budget -> capacity solver --------------------------

def stack_flops_per_token(cfg, spec: ElasticSpec, *, ctx: int = 1024):
    """Analytic per-token forward FLOPs, split into (fixed, routed) parts:
    parameter matmuls at 2 FLOPs/MAC plus the quadratic attention term at
    average context ``ctx``, decomposed per elastic knob. ``routed`` maps
    knob name -> FLOPs that scale with that knob's fraction."""
    D, F = cfg.d_model, cfg.d_ff
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    fixed = 2 * cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    attn_head = attn_kv = mlp = mixer = 0.0
    n_gate = 3 if cfg.act in ("swiglu", "geglu") else 2
    for i, kind in enumerate(cfg.layer_kinds):
        elastic_l = spec.applies_to_layer(i)
        if kind in ("attn", "xattn"):
            w = cfg.layer_windows[i]
            c = min(ctx, w) if (w and w > 0) else ctx
            qo = 2 * 2 * D * H * Dh
            kv = 2 * 2 * D * K * Dh
            quad = 2 * 2 * c * H * Dh
            if kind == "xattn":
                qo, kv, quad = 2 * qo, 2 * kv, 2 * quad
            if elastic_l:
                attn_head += qo + quad
                attn_kv += kv
            else:
                fixed += qo + kv + quad
        if kind != "ssm":
            if cfg.moe is not None:
                m = cfg.moe
                c_mlp = m.top_k * n_gate * 2 * D * m.d_expert
                if m.n_shared_experts:
                    fixed += n_gate * 2 * D * m.d_shared
            else:
                c_mlp = n_gate * 2 * D * F
            if elastic_l:
                mlp += c_mlp
            else:
                fixed += c_mlp
    routed = {"attn_head": attn_head, "attn_kv": attn_kv,
              "mlp": mlp, "mixer": mixer}
    return fixed, routed


def _active_fraction(cfg, spec: ElasticSpec, s: float, *, ctx: int) -> float:
    """FLOP fraction of the full model when every enabled knob is set to
    fraction ``s`` (top-k values rounded to real integer counts)."""
    fixed, routed = stack_flops_per_token(cfg, spec, ctx=ctx)
    frac_depth = s if spec.depth_routed else 1.0
    cap_tok_mha = (s if spec.mha_token_routed else 1.0) * frac_depth
    cap_tok_mlp = (s if spec.mlp_token_routed else 1.0) * frac_depth
    frac_head = 1.0
    if spec.mha_head_routed:
        frac_head = max(1, math.ceil(s * cfg.n_heads - 1e-9)) / cfg.n_heads
    frac_exp = 1.0
    if spec.expert_routed:
        n_e = cfg.moe.n_experts if cfg.moe is not None else spec.mlp_n_experts
        if n_e:
            frac_exp = max(1, math.ceil(s * n_e - 1e-9)) / n_e
    active = (fixed
              + routed["attn_head"] * cap_tok_mha * frac_head
              + routed["attn_kv"] * cap_tok_mha
              + routed["mixer"] * cap_tok_mha
              + routed["mlp"] * cap_tok_mlp * frac_exp)
    total = fixed + sum(routed.values())
    return active / max(total, 1.0)


def solve_budget(cfg, spec: ElasticSpec, budget: float, *, ctx: int = 1024,
                 theta: float = 0.5, static: bool = False,
                 iters: int = 40) -> ElasticPolicy:
    """Bisect the shared knob fraction ``s`` so the model's active-FLOP
    fraction hits ``budget``; budget >= 1 is exactly the teacher."""
    if budget >= 1.0:
        return ElasticPolicy.uniform(1.0, theta=theta, static=static)
    lo, hi = 1e-3, 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if _active_fraction(cfg, spec, mid, ctx=ctx) > budget:
            hi = mid
        else:
            lo = mid
    s = 0.5 * (lo + hi)
    n_e = cfg.moe.n_experts if cfg.moe is not None else spec.mlp_n_experts
    return ElasticPolicy.uniform(
        s, n_heads=cfg.n_heads if spec.mha_head_routed else None,
        n_experts=n_e if spec.expert_routed else None,
        theta=theta, static=static)


# ------------------------------ schedules ------------------------------------

def capacity_anneal(start: float, end: float, steps: int):
    """Linear budget schedule for distillation: step -> budget, from
    ``start`` down to ``end`` over ``steps`` steps."""
    def at(step: int) -> float:
        if steps <= 0:
            return end
        t = min(1.0, max(0.0, step / steps))
        return start + (end - start) * t
    return at
