"""Self-distillation objectives (paper §4.2, Fig. 4).

  * forward KL  D_KL(p_student || p_teacher)   (the paper's naming)
  * reverse KL  D_KL(p_teacher || p_student)
  * top-K KL: the teacher's probabilities reduced to a (K+1)-vector, its
    top-K plus a residual bucket, and the student's arranged by the
    teacher's top-K token indices;
  * temperature scaling of both logit sets before the softmax.

The paper adopts forward KL on the top-50 tokens for LMs, and the cosine
distance between output embeddings for ViT encoders. Everything is f32.
"""
from __future__ import annotations

import torch


def _log_softmax(logits, temp: float):
    return torch.log_softmax(logits.float() / temp, dim=-1)


def kl_divergence(student_logits, teacher_logits, temp: float = 1.0,
                  direction: str = "fwd"):
    """Full-vocab KL per token, meaned: 'fwd' = KL(student || teacher),
    'rev' = KL(teacher || student)."""
    ls = _log_softmax(student_logits, temp)
    lt = _log_softmax(teacher_logits, temp)
    if direction == "fwd":
        kl = (ls.exp() * (ls - lt)).sum(-1)
    else:
        kl = (lt.exp() * (lt - ls)).sum(-1)
    return kl.mean() * temp * temp


def topk_kl(student_logits, teacher_logits, k: int = 50, temp: float = 1.0,
            direction: str = "fwd"):
    """Top-K KL (§4.2): (K+1)-dim distributions with a residual bucket."""
    lt = _log_softmax(teacher_logits, temp)
    ls = _log_softmax(student_logits, temp)
    t_top, t_idx = torch.topk(lt, k, dim=-1)
    s_top = torch.gather(ls, -1, t_idx)
    return _residual_bucket_kl(s_top, t_top, direction) * temp * temp


def topk_kl_from_gathered(s_top, t_top, direction: str = "fwd"):
    """``topk_kl`` on already-gathered top-K log-probabilities."""
    return _residual_bucket_kl(s_top, t_top, direction)


def _residual_bucket_kl(s_top, t_top, direction):
    def aug(logp):
        resid = torch.clamp(1.0 - logp.exp().sum(-1, keepdim=True),
                            1e-9, 1.0)
        return torch.cat([logp, torch.log(resid)], dim=-1)
    ls, lt = aug(s_top), aug(t_top)
    if direction == "fwd":
        kl = (ls.exp() * (ls - lt)).sum(-1)
    else:
        kl = (lt.exp() * (lt - ls)).sum(-1)
    return kl.mean()


def cosine_distance(student_emb, teacher_emb, eps: float = 1e-6):
    """ViT-encoder objective: 1 - cos(student, teacher) per token, meaned."""
    s, t = student_emb.float(), teacher_emb.float()
    num = (s * t).sum(-1)
    den = torch.linalg.vector_norm(s, dim=-1) * \
        torch.linalg.vector_norm(t, dim=-1) + eps
    return (1.0 - num / den).mean()


def distill_loss(student_out, teacher_out, ecfg, mask=None):
    """Dispatch on ``ecfg.distill_loss``; ``*_out`` are logits (LM) or
    embeddings (ViT)."""
    kind = ecfg.distill_loss
    if kind == "cosine":
        return cosine_distance(student_out, teacher_out)
    if kind == "topk_kl":
        return topk_kl(student_out, teacher_out, k=ecfg.distill_topk,
                       temp=ecfg.distill_temp, direction="fwd")
    if kind == "topk_kl_rev":
        return topk_kl(student_out, teacher_out, k=ecfg.distill_topk,
                       temp=ecfg.distill_temp, direction="rev")
    if kind == "fwd_kl":
        return kl_divergence(student_out, teacher_out, ecfg.distill_temp,
                             "fwd")
    if kind == "rev_kl":
        return kl_divergence(student_out, teacher_out, ecfg.distill_temp,
                             "rev")
    raise ValueError(f"unknown distill loss {kind}")
