"""AdamW with the paper's schedule (cosine decay, 3 % warmup) and global-norm
clipping, written out as the JAX package writes it (not ``torch.optim``):
bias correction at ``step + 1`` in f32, decoupled weight decay inside the
update, a functional ``AdamWState(step, m, v)``.

Only the router tree (token routers, head router, LoRA) is trainable, so the
state is tiny; the frozen base model carries none. Trees are nested dicts
and lists of tensors (the port's router layout).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    m: dict
    v: dict


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of the same structure (dicts and
    lists are nodes; anything else, tuples included, is a leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_frac: float = 0.03, final_frac: float = 0.0):
    """step -> learning rate (an f32 tensor): linear warmup over
    ``max(1, int(total_steps * warmup_frac))`` steps, then cosine decay."""
    warmup = max(1, int(total_steps * warmup_frac))

    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / warmup
        prog = torch.clamp((step - warmup) / max(1, total_steps - warmup),
                           0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale, grads), g


def adamw_init(params) -> AdamWState:
    z = lambda t: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                           t)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      z(params), z(params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, max_grad_norm=1.0):
    """Returns (new_params, new_state, metrics). ``lr`` is a schedule (a
    function of the step) or a number; weight decay is decoupled."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.as_tensor(
        lr, dtype=torch.float32)
    lr_t = lr_t.to(step.device)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return m, v, (p.float() - lr_t * delta).to(p.dtype)

    out = tree_map(upd, grads, state.m, state.v, params)
    pick = lambda j: tree_map(lambda o: o[j], out)
    return pick(2), AdamWState(step, pick(0), pick(1)), {
        "grad_norm": gnorm, "lr": lr_t}
