"""ElastiFormer routing primitives, the serving subset (paper Alg. 1 & §B).

  * input subset selection — a scalar sigmoid router per token; at
    inference a threshold theta on the sigmoid (§B.1);
  * parameter subset selection — an M-way router, w = M * softmax(W_r x),
    top-k submodules, output scaling.

Policy leaves are Python numbers (static) or float32 tensors (``()`` or
``(B,)``). A Python top-k keeps every entry ``>= kth`` (ties all kept); a
tensor top-k keeps the entries whose descending rank is below k, ranks from
a STABLE sort so ties break by ascending position — the JAX package's two
semantics. Any capacity >= 1 (or top-k >= M, or ``student <= 0``) forces
the exact unrouted module: weights are exactly 1. Router math is f32.

The train-mode top-k plan (``make_plan``, the ragged bucket) waits for the
training slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


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


def token_ranks(scores):
    """Descending rank of each entry along the last axis (0 = largest);
    ties break by ascending position (stable sort, then one scatter)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    ar = torch.arange(scores.shape[-1], device=scores.device)
    return torch.empty_like(order).scatter_(-1, order, ar.expand_as(order))


def topk_mask_dyn(scores, k):
    """Top-k membership with a tensor k ((), or leading dims): rank < k."""
    return token_ranks(scores) < bcast_to(k, scores.dim())


def topk_mask_any(scores, k):
    if is_static(k):
        return topk_mask(scores, int(k))
    return topk_mask_dyn(scores, k)


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


def token_gate(logits, scores, capacity, mode: str, *, theta=0.5):
    """Keep-mask and router weight for input subset selection, inference
    (threshold theta on the router sigmoid, §B.1). Any capacity >= 1 forces
    (keep all, weight exactly 1). Returns (keep bool, weight f32)."""
    if mode == "train":
        raise NotImplementedError(
            "train-mode top-k routing arrives with the training slice "
            "(ROADMAP Queue A item 3)")
    keep = logits > bcast_to(threshold_logit(theta), logits.dim())
    full = is_full(capacity)
    if is_static(full):
        if full:
            return torch.ones_like(keep), torch.ones_like(scores)
        return keep, keep * scores
    full = bcast_to(full, keep.dim())
    keep = keep | full
    return keep, torch.where(full, torch.ones_like(scores), keep * scores)


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


def param_route_weights(rp, x, top_k, normalize_to_m: bool = True):
    """Alg. 1: w = M * softmax(W_r x) and its top-k mask. ``top_k`` is a
    Python int or a () / (B,) tensor (rank masking).
    Returns (weights (..., M) f32, mask (..., M) bool, aux)."""
    m = rp["w"].shape[-1]
    logits = x.float() @ rp["w"]
    probs = torch.softmax(logits, dim=-1)
    w = probs * m if normalize_to_m else probs
    k = min(int(top_k), m) if is_static(top_k) else torch.clamp(top_k, 1, m)
    mask = topk_mask_any(w, k)
    red = tuple(range(probs.dim() - 1))
    frac = mask.float().mean(dim=red)
    load = m * (frac * probs.mean(dim=red)).sum()
    return w, mask, RouteAux.of(load=load)
