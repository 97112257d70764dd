"""ElastiFormer routing primitives (paper Alg. 1 & 2, §B).

  * input subset selection — a scalar sigmoid router per token: top-k
    (k = c * S) in training, a threshold theta on the sigmoid at inference
    (§B.1), with a BCE aux loss teaching the sigmoid the top-k membership;
  * parameter subset selection — an M-way router, w = M * softmax(W_r x),
    top-k submodules, output scaling.

Policy leaves are Python numbers (static) or float32 tensors (``()`` or
``(B,)``). A Python top-k keeps every entry ``>= kth`` (ties all kept); a
tensor top-k keeps the entries whose descending rank is below k, ranks from
a STABLE sort so ties break by ascending position — the JAX package's two
semantics. Any capacity >= 1 (or top-k >= M, or ``student <= 0``) forces
the exact unrouted module: weights are exactly 1. Router math is f32.

Train-mode token routing is one ``RoutingPlan`` per block, built by
``make_plan`` from ONE stable sort: the selected tokens form a
position-ascending prefix of a static ragged bucket (``capacity_buckets``,
``bucket_for``, ``resolve_bucket``), the true count rides along as a tensor
that the kernels use to skip trailing tiles. The bucket constants and the
``mxu`` rounding of ``capacity_k`` are the JAX package's, kept as they are
so that both select the same tokens.

Under a mesh every rank builds the same plan from the same (all-reduced)
residual stream with replicated routers, so no collective is needed;
``check_plan_replicated`` (on under ``Mesh(debug=True)``) verifies it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.runtime import collectives as C
from repro_torch.runtime.mesh import active_mesh


def _z(device=None):
    return torch.zeros((), dtype=torch.float32, device=device)


class RouteAux(NamedTuple):
    load: torch.Tensor   # load-balance loss contribution (scalar)
    topk: torch.Tensor   # BCE top-k consistency loss contribution (scalar)
    sel: torch.Tensor    # sum over routers of selected-token fraction
    cnt: torch.Tensor    # number of routers contributing to `sel`

    @staticmethod
    def zero(device=None):
        return RouteAux(_z(device), _z(device), _z(device), _z(device))

    @staticmethod
    def of(load=None, topk=None, keep=None):
        """keep: bool selection mask -> records its mean as a sel-rate."""
        ref = next(t for t in (load, topk, keep) if t is not None)
        sel = keep.float().mean() if keep is not None else _z(ref.device)
        cnt = (torch.ones((), dtype=torch.float32, device=ref.device)
               if keep is not None else _z(ref.device))
        return RouteAux(load if load is not None else _z(ref.device),
                        topk if topk is not None else _z(ref.device),
                        sel, cnt)

    def __add__(self, o):
        return RouteAux(self.load + o.load, self.topk + o.topk,
                        self.sel + o.sel, self.cnt + o.cnt)

    @property
    def sel_rate(self):
        """Mean fraction of tokens processed across token routers."""
        return self.sel / torch.clamp(self.cnt, min=1.0)


# ----------------------- input subset selection -----------------------------

def token_router_init(gen: torch.Generator, d: int, device=None) -> dict:
    w = torch.randn((d,), generator=gen, dtype=torch.float32,
                    device=device) / math.sqrt(d)
    return {"w": w, "b": torch.zeros((), dtype=torch.float32, device=device)}


def token_logits(rp, x):
    """Scalar routing logits per token. x: (..., D) -> (...,) f32."""
    return x.float() @ rp["w"] + rp["b"]


def topk_indices(scores, k: int):
    """Top-k indices along the last axis, ascending (causal order). Ties
    go to the lower index, as ``jax.lax.top_k`` breaks them."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(idx[..., :k], dim=-1).values


def topk_mask(scores, k: int):
    """Membership mask of the top-k entries along the last axis (static k:
    every entry >= the k-th largest, ties all kept)."""
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    return scores >= kth


# ----------------- static/tensor scalar plumbing (policy leaves) -------------

def is_static(v) -> bool:
    """True for Python numbers; tensor policy leaves are not static."""
    return isinstance(v, (int, float))


def bcast_to(v, ndim: int):
    """Right-pad a leading-dims value ((), (B,), ...) with singleton axes so
    it broadcasts against a (B, ..., n) tensor of rank ``ndim``."""
    if is_static(v):
        return v
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.dim()))


# Counter over the sorts issued by the routing machinery (the test hook
# behind "one RoutingPlan sort per block"). Every argsort in this module
# goes through _argsort so the count is honest.
PLAN_SORT_COUNT = 0


def _argsort(x):
    """Stable ascending argsort along the last axis: ties keep ascending
    position, as ``jnp.argsort`` does (``torch.topk`` and an unstable sort
    give no such order on CUDA)."""
    global PLAN_SORT_COUNT
    PLAN_SORT_COUNT += 1
    return torch.argsort(x, dim=-1, stable=True)


def invert_permutation(perm):
    """Inverse of a batched permutation along the last axis without a
    second sort: inv[..., perm[..., i]] = i by one scatter."""
    ar = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, ar.expand_as(perm))


def token_ranks(scores):
    """Descending rank of each entry along the last axis (0 = largest);
    ONE stable sort, ties by ascending position, inverse by scatter."""
    return invert_permutation(_argsort(-scores))


def topk_mask_dyn(scores, k):
    """Top-k membership with a tensor k ((), or leading dims): rank < k."""
    return token_ranks(scores) < bcast_to(k, scores.dim())


def topk_mask_any(scores, k):
    if is_static(k):
        return topk_mask(scores, int(k))
    return topk_mask_dyn(scores, k)


def capacity_k(capacity, s: int, mxu: bool = False):
    """ceil(capacity * s) clipped to [1, s]; a Python int when static.
    ``mxu``: for s >= 1024 round the count up to a multiple of 128, the
    JAX package's rule (kept so both select the same tokens)."""
    if is_static(capacity):
        k = int(math.ceil(capacity * s))
        if mxu and s >= 1024:
            k = min(s, -(-k // 128) * 128)
        return max(1, min(s, k))
    k = torch.ceil(capacity * s)
    if mxu and s >= 1024:
        k = torch.clamp(torch.ceil(k / 128) * 128, max=s)
    return torch.clamp(k, 1, s)


# --------------------- ragged capacity buckets ------------------------------

RAGGED_N_BUCKETS = 4     # static buffer sizes per sequence length, max
RAGGED_ALIGN = 128       # bucket alignment (the TPU's lane width, kept)

# Bucket hint meaning "every row is at full budget": the identity path (no
# partition, gather or scatter; the teacher's math bit for bit). Not a
# valid buffer size, so it never collides with a real bucket.
IDENTITY_BUCKET = -1


def capacity_buckets(s: int, *, n_buckets: int = RAGGED_N_BUCKETS,
                     align: int = RAGGED_ALIGN):
    """Static buffer sizes for sequence length ``s``: ``n_buckets`` evenly
    spaced fractions of s, each rounded up to a multiple of ``align``
    (shrunk on short sequences so buckets stay distinct), capped at s."""
    align = max(1, min(align, -(-s // n_buckets)))
    out = []
    for i in range(1, n_buckets + 1):
        b = -(-s * i // n_buckets)
        b = min(s, -(-b // align) * align)
        if not out or b > out[-1]:
            out.append(b)
    return tuple(out)


def bucket_for(k: int, s: int, *, n_buckets: int = RAGGED_N_BUCKETS,
               align: int = RAGGED_ALIGN) -> int:
    """Smallest bucket >= k tokens (k <= s)."""
    for b in capacity_buckets(s, n_buckets=n_buckets, align=align):
        if b >= k:
            return b
    return s


class RoutingPlan(NamedTuple):
    """One block's token-routing decision, from a SINGLE sort.

    idx   : (B, bucket) int64 gather indices; the selected tokens form a
            position-ascending prefix, the tail holds the other tokens
            (position-ascending) and is masked by ``valid``.
    inv   : (B, S) int64 inverse permutation: token position -> buffer
            slot (>= bucket: the token is not in the buffer).
    valid : (B, bucket) bool prefix validity.
    count : Python int (static k) or (B,) int32 true selected count.
    keep  : (B, S) bool membership (BCE target).
    bucket: static buffer size.
    """
    idx: torch.Tensor
    inv: torch.Tensor
    valid: torch.Tensor
    count: object
    keep: torch.Tensor
    bucket: int


def make_plan(scores, k, bucket: int) -> RoutingPlan:
    """A RoutingPlan from router scores (B, S) with ONE sort. ``k``: a
    Python int or a () / (B,) tensor, clamped to ``bucket``. The ranks are
    the sort's inverse (scatter), the valid-first destination of every
    token a cumsum over the keep mask, the gather indices its inverse."""
    ranks = token_ranks(scores)                       # the one sort
    if is_static(k):
        count = max(1, min(int(k), bucket))
        keep = ranks < count
    else:
        kk = torch.clamp(k, max=bucket)
        keep = ranks < bcast_to(kk, scores.dim())
        count = keep.sum(-1).to(torch.int32)
    nk = torch.cumsum(keep.to(torch.int64), -1)
    n_keep = nk[..., -1:]
    dest = torch.where(keep, nk - 1,
                       n_keep + torch.cumsum((~keep).to(torch.int64), -1) - 1)
    idx = invert_permutation(dest)[..., :bucket]
    ar = torch.arange(bucket, device=scores.device)
    if is_static(k):
        valid = (ar < count).expand(idx.shape)
    else:
        valid = ar < count[..., None]
    plan = RoutingPlan(idx, dest, valid, count, keep, bucket)
    check_plan_replicated(plan)
    return plan


def check_plan_replicated(plan: "RoutingPlan") -> None:
    """Under an active ``Mesh(debug=True)``: raise unless every rank of
    the ``model`` axis built the same plan (gather indices and counts).
    Every TP shard of a block must route the same tokens through its
    weight shard; the counterpart of the JAX package's
    ``constrain_plan``, which pins the plan replicated over ``model``.
    A no-op otherwise."""
    mesh = active_mesh()
    if mesh is None or not mesh.debug:
        return
    C.assert_replicated(plan.idx, "the RoutingPlan's idx", mesh)
    if torch.is_tensor(plan.count):
        C.assert_replicated(plan.count, "the RoutingPlan's count", mesh)


def _expand_idx(idx, ndim: int):
    return idx.reshape(tuple(idx.shape) + (1,) * (ndim - idx.dim()))


def gather_tokens(x, idx):
    """x: (B, S, ...), idx: (B, k) -> (B, k, ...)."""
    ix = _expand_idx(idx, x.dim()).expand(tuple(idx.shape) + x.shape[2:])
    return torch.gather(x, 1, ix)


def plan_gather(x, plan: RoutingPlan):
    """x: (B, S, ...) -> (B, bucket, ...) selected-first buffer."""
    return gather_tokens(x, plan.idx)


def plan_scatter(plan: RoutingPlan, shape_like, vals):
    """Inverse of plan_gather as a GATHER by the inverse permutation (not
    a scatter-add). vals: (B, bucket, ...) already weighted; tokens the
    plan did not select get zeros."""
    b = plan.bucket
    safe = torch.clamp(plan.inv, max=b - 1)
    out = gather_tokens(vals, safe)
    live = _expand_idx((plan.inv < b) & plan.keep, out.dim())
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)
                       ).to(shape_like.dtype)


def resolve_bucket(capacity, s: int, bucket=None, impl: str = "ragged"):
    """Static plan buffer size: ``None`` (no static plan: the dense
    rank-masked path), ``s`` (the identity path: every row at full budget)
    or ``0 < b < s`` (the ragged bucket; under ``impl == "gather"`` the
    exact rounded top-k). Static capacities derive it here, tensor ones
    ride the caller's ``bucket`` hint (``policy.ragged_bucket``), where
    ``IDENTITY_BUCKET`` asserts the identity path."""
    if capacity is None:
        return None
    if is_static(capacity):
        if capacity >= 1.0:
            return s
        k = capacity_k(capacity, s, mxu=True)
        kb = min(s, k if impl == "gather" else bucket_for(k, s))
        return kb if kb < s else None
    if bucket is None:
        return None
    kb = int(bucket)
    if kb == IDENTITY_BUCKET:
        return s
    return kb if kb < s else None


def threshold_logit(theta):
    """Router-logit threshold equivalent to sigmoid(logit) > theta."""
    if is_static(theta):
        if 0.0 < theta < 1.0:
            return math.log(theta / (1.0 - theta))
        return -math.inf if theta <= 0.0 else math.inf
    theta = torch.clamp(theta.float(), 1e-6, 1.0 - 1e-6)
    return torch.log(theta) - torch.log1p(-theta)


def gate_capacity(capacity, student):
    """Teacher gating: ``student <= 0`` forces full capacity (exact teacher)."""
    if student is None:
        return capacity
    if is_static(student):
        return capacity if student > 0 else 1.0
    cap = capacity if not is_static(capacity) else torch.tensor(
        capacity, dtype=torch.float32, device=student.device)
    return torch.where(student > 0, cap, torch.ones_like(cap))


def gate_topk(k, student, n: int):
    """Teacher gating for parameter-subset top-k: student off -> all n."""
    if student is None:
        return k
    if is_static(student):
        return k if student > 0 else n
    kk = k if not is_static(k) else torch.tensor(
        k, dtype=torch.float32, device=student.device)
    return torch.where(student > 0, kk, torch.full_like(kk, n))


def is_full(v, limit=1.0):
    """capacity >= 1 (or top-k >= M): the knob requests the exact teacher.
    Python bool when static, else a bool tensor."""
    return v >= limit


def token_gate(logits, scores, capacity, mode: str, *, theta=0.5,
               mxu: bool = False):
    """Keep-mask and router weight for input subset selection: top-k by
    capacity in training (rank masking at full shape), a threshold theta
    on the router sigmoid at inference (§B.1). Any capacity >= 1 forces
    (keep all, weight exactly 1). Returns (keep bool, weight f32)."""
    if mode == "train":
        keep = topk_mask_any(scores, capacity_k(capacity, scores.shape[-1],
                                                mxu=mxu))
    else:
        keep = logits > bcast_to(threshold_logit(theta), logits.dim())
    full = is_full(capacity)
    if is_static(full):
        if full:
            return torch.ones_like(keep), torch.ones_like(scores)
        return keep, keep * scores
    full = bcast_to(full, keep.dim())
    keep = keep | full
    return keep, torch.where(full, torch.ones_like(scores), keep * scores)


def bce_topk_loss(logits, in_topk):
    """§B.1 aux loss: the router sigmoid should predict top-k membership."""
    y = in_topk.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def route_tokens(rp, x, f, capacity, mode: str, positions=None, theta=0.5,
                 student=None):
    """Input subset selection around a module f (residual added by the
    caller), base and dense/threshold inference branches: f runs on every
    token and its output is weighted by the gate. Returns (delta, aux)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if capacity is None or mode == "base":
        return f(x, positions), RouteAux.zero(x.device)
    capacity = gate_capacity(capacity, student)
    logits = token_logits(rp, x)
    scores = torch.sigmoid(logits)
    keep, w = token_gate(logits, scores, capacity, mode, theta=theta)
    y = f(x, positions)
    return y * w[..., None].to(y.dtype), RouteAux.of(keep=keep)


# --------------------- parameter subset selection ---------------------------

def param_router_init(gen: torch.Generator, d: int, m: int,
                      device=None) -> dict:
    w = torch.randn((d, m), generator=gen, dtype=torch.float32,
                    device=device) / math.sqrt(d)
    return {"w": w}


def param_route_weights(rp, x, top_k, normalize_to_m: bool = True,
                        valid=None):
    """Alg. 1: w = M * softmax(W_r x) and its top-k mask. ``top_k`` is a
    Python int or a () / (B,) tensor (rank masking). ``valid`` (x's leading
    dims) keeps rows out of the load-balance statistics (a bucket buffer's
    masked tail). Returns (weights (..., M) f32, mask (..., M) bool, aux)."""
    m = rp["w"].shape[-1]
    logits = x.float() @ rp["w"]
    probs = torch.softmax(logits, dim=-1)
    w = probs * m if normalize_to_m else probs
    k = min(int(top_k), m) if is_static(top_k) else torch.clamp(top_k, 1, m)
    mask = topk_mask_any(w, k)
    red = tuple(range(probs.dim() - 1))
    if valid is None:
        frac = mask.float().mean(dim=red)
        mean_p = probs.mean(dim=red)
    else:
        vw = valid.float()[..., None]
        denom = torch.clamp(vw.sum(), min=1.0)
        frac = (mask * vw).sum(dim=red) / denom
        mean_p = (probs * vw).sum(dim=red) / denom
    load = m * (frac * mean_p).sum()
    return w, mask, RouteAux.of(load=load)
