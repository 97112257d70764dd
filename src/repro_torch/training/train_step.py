"""Self-distillation training step (paper §4.2):

    L = L_distill + lambda_load * L_load + lambda_topk * L_topk

Teacher = the frozen base model (``mode="base"``, under ``torch.no_grad``:
the counterpart of ``stop_gradient``); student = the same frozen weights
plus the trainable router tree (token routers, head router, LoRA) in
``mode="train"``. Gradients flow only into the router tree: the base params
never require a gradient, so the optimizer state is tiny.

The top-K KL is computed from the final hidden states chunk by chunk over
the sequence (``chunked_topk_kl``), so the full (B, S, V) logits never
exist; each chunk is recomputed in the backward pass. A VLM's or
encoder-decoder's batch carries its context (``image_embeds`` /
``frames``) beside ``tokens`` and takes the same path (its ``vlm`` and
encoder routers train through it); an encoder (``family="encoder"``, a
ViT over ``embeds``) distils its output embeddings by the cosine
distance, the paper's objective for image encoders. The multi-GPU branch
(vocab-sharded top-K candidates) and error-feedback gradient compression
wait for training on a mesh (ROADMAP Queue A item 11, part 4).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.distill import (cosine_distance, distill_loss,
                                     topk_kl_from_gathered)
from repro_torch.core.policy import as_spec_policy
from repro_torch.models import forward
from repro_torch.optim.optimizer import (AdamWState, adamw_init, adamw_update,
                                         tree_leaves, tree_map)

MULTI_GPU_TODO = ("arrives with training on a mesh (ROADMAP Queue A item 11, "
                  "part 4)")
METRICS = ("loss", "distill", "aux_load", "aux_topk", "sel_rate")


class TrainState(NamedTuple):
    router_params: dict
    opt: AdamWState
    ef: Optional[object]     # error-feedback state: the multi-GPU slice


def init_train_state(router_params, use_compression: bool = False):
    if use_compression:
        raise NotImplementedError(f"gradient compression {MULTI_GPU_TODO}")
    return TrainState(router_params, adamw_init(router_params), None)


# --------------------------- chunked top-k KL --------------------------------

def _head_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _chunk_kl(hs, ht, head, *, k, vocab, direction, temp, full):
    lt = (ht @ head).float() / temp
    ls = (hs @ head).float() / temp
    if head.shape[-1] != vocab:
        v = torch.arange(head.shape[-1], device=hs.device) < vocab
        neg = torch.full((), -1e30, device=hs.device)
        lt, ls = torch.where(v, lt, neg), torch.where(v, ls, neg)
    lt = torch.log_softmax(lt, dim=-1)
    ls = torch.log_softmax(ls, dim=-1)
    if full:
        if direction == "fwd":
            return (ls.exp() * (ls - lt)).sum(-1).mean()
        return (lt.exp() * (lt - ls)).sum(-1).mean()
    t_top, idx = torch.topk(lt, k, dim=-1)
    return topk_kl_from_gathered(torch.gather(ls, -1, idx), t_top, direction)


def chunked_topk_kl(h_student, h_teacher, head, *, k: int, vocab: int,
                    mesh=None, seq_chunk: int = 512, direction: str = "fwd",
                    temp: float = 1.0, full: bool = False):
    """h_*: (B, S, D) final hidden states; head: (D, V). The exact top-k KL
    with residual bucket (``full=False``, the paper's default) or the exact
    full-vocab KL, meaned over sequence chunks of ``seq_chunk`` tokens (the
    largest divisor of S not above it). Each chunk's logits exist only
    while it is computed, and again in the backward pass."""
    if mesh is not None:
        raise NotImplementedError(f"the vocab-sharded KL {MULTI_GPU_TODO}")
    S = h_student.shape[1]
    c = min(seq_chunk, S)
    while S % c:
        c -= 1

    def body(hs, ht):
        return _chunk_kl(hs, ht, head, k=k, vocab=vocab, direction=direction,
                         temp=temp, full=full)

    kls = []
    for i in range(S // c):
        hs, ht = h_student[:, i * c:(i + 1) * c], h_teacher[:, i * c:(i + 1) * c]
        if hs.requires_grad:
            kls.append(torch.utils.checkpoint.checkpoint(
                body, hs, ht, use_reentrant=False))
        else:
            kls.append(body(hs, ht))
    return torch.stack(kls).mean() * temp * temp


def lm_loss(logits, tokens):
    """Next-token cross entropy (the paper's LM loss metric)."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()


# ------------------------------- train step ----------------------------------

def make_loss_fn(cfg, ecfg, *, mesh=None, remat: bool = False,
                 chunked: bool = True, seq_chunk: int = 512):
    """Returns ``loss_fn(router_params, params, batch, policy=None,
    bucket=None, teacher_out=None) -> (loss, metrics)``. ``policy`` is an
    ElasticPolicy (tensor leaves anneal with no other change), ``bucket``
    its ragged bucket (``policy.ragged_bucket``). ``teacher_out`` is
    ``loss_fn.teacher(params, batch)``, the frozen teacher's output, when
    the caller has it; otherwise it is computed here."""
    if mesh is not None:
        raise NotImplementedError(f"training on a mesh {MULTI_GPU_TODO}")
    encoder = cfg.family == "encoder"
    use_hidden = chunked and not encoder and cfg.vocab_size > 0
    spec, default_pol = as_spec_policy(ecfg)

    @torch.no_grad()
    def teacher(params, batch):
        return forward(params, None, batch, cfg, spec, mode="base",
                       return_hidden=use_hidden)[0]

    def loss_fn(router_params, params, batch, policy=None, bucket=None,
                teacher_out=None):
        pol = policy if policy is not None else default_pol
        t_out = teacher(params, batch) if teacher_out is None \
            else teacher_out
        s_out, aux = forward(params, router_params, batch, cfg, spec,
                             mode="train", return_hidden=use_hidden,
                             remat=remat, policy=pol, bucket=bucket)
        if encoder:
            dist = cosine_distance(s_out, t_out)
        elif use_hidden:
            direction = "rev" if "rev" in spec.distill_loss else "fwd"
            dist = chunked_topk_kl(
                s_out, t_out, _head_matrix(params, cfg), k=spec.distill_topk,
                vocab=cfg.vocab_size, seq_chunk=seq_chunk,
                direction=direction, temp=spec.distill_temp,
                full=spec.distill_loss in ("fwd_kl", "rev_kl"))
        else:
            dist = distill_loss(s_out, t_out, spec)
        loss = (dist + spec.lambda_load * aux.load
                + spec.lambda_topk * aux.topk)
        return loss, {"loss": loss, "distill": dist, "aux_load": aux.load,
                      "aux_topk": aux.topk, "sel_rate": aux.sel_rate}

    loss_fn.teacher = teacher
    return loss_fn


def _sync(batch: dict) -> float:
    """Host clock after the card has finished the work queued so far (on
    the device of the batch's tensors)."""
    t = next(iter(batch.values()))
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def make_train_step(cfg, ecfg, *, lr, weight_decay: float = 0.0,
                    max_grad_norm: float = 1.0, mesh=None,
                    remat: bool = False, chunked: bool = True,
                    compress_axis: Optional[str] = None,
                    microbatch: Optional[int] = None):
    """Returns ``train_step(state, params, batch, policy=None, bucket=None,
    timing=None) -> (state, metrics)``. ``params`` (the frozen base model)
    and ``policy`` are passed per call; ``bucket`` is the policy's ragged
    bucket. ``microbatch=M`` accumulates gradients over M sequential slices
    of the batch (per-request (B,) policy leaves are not sliced). A
    ``timing`` dict receives the host-clock seconds of the teacher forward
    (``teacher_s``) and of the student forward, backward and update
    (``student_s``), with the card synchronised at each boundary."""
    if compress_axis is not None:
        raise NotImplementedError(f"gradient compression {MULTI_GPU_TODO}")
    loss_fn = make_loss_fn(cfg, ecfg, mesh=mesh, remat=remat,
                           chunked=chunked)

    def value_and_grad(rp, params, batch, policy, bucket, timing):
        if timing is not None:
            t0 = _sync(batch)
        t_out = loss_fn.teacher(params, batch)
        if timing is not None:
            timing["teacher_s"] += _sync(batch) - t0
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), rp)
        loss, metrics = loss_fn(leaves, params, batch, policy, bucket,
                                teacher_out=t_out)
        flat = tree_leaves(leaves)
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = tree_map(lambda p: next(gs), leaves)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                         grads, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grads_of(rp, params, batch, policy, bucket, timing):
        if not microbatch or microbatch <= 1:
            return value_and_grad(rp, params, batch, policy, bucket, timing)
        g_acc = m_acc = None
        for i in range(microbatch):
            mb = {k: v.chunk(microbatch, dim=0)[i] for k, v in batch.items()}
            g, m = value_and_grad(rp, params, mb, policy, bucket, timing)
            g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
            m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
        inv = 1.0 / microbatch
        return (tree_map(lambda x: x * inv, g_acc),
                {k: v * inv for k, v in m_acc.items()})

    def train_step(state: TrainState, params, batch, policy=None,
                   bucket=None, timing: Optional[dict] = None):
        if timing is not None:
            timing["teacher_s"] = 0.0
            t0 = _sync(batch)
        grads, metrics = grads_of(state.router_params, params, batch, policy,
                                  bucket, timing)
        new_rp, opt, om = adamw_update(
            grads, state.opt, state.router_params, lr=lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        metrics.update(om)
        if timing is not None:
            timing["student_s"] = (_sync(batch) - t0
                                   - timing["teacher_s"])
        return TrainState(new_rp, opt, None), metrics

    return train_step
