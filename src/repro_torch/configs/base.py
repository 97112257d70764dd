"""Model and elastic configs for the PyTorch port.

An own copy of what the port needs from the JAX package's
``configs/base.py`` (the two packages share no code). The one deliberate
difference is head padding: ``get_config`` keeps ``head_pad=1`` unless the
caller asks for more (the JAX package pads every full config to 16, its
TPU pod's ``model`` axis). Padded q-heads compute what the JAX package
computes on the CPU (``models/attention.py``), but the attention kernels'
head -> kv-group map does not fit them, so on the card they raise until
ROADMAP Queue A item 11 (part 7) brings padded heads to the kernels; the port's
tensor parallelism shards unpadded heads that divide the ``model`` axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Native mixture-of-experts MLP config (qwen2-moe, grok-1)."""
    n_experts: int
    top_k: int
    d_expert: int                  # ffn dim per expert
    n_shared_experts: int = 0      # shared (always-on) experts
    d_shared: int = 0              # ffn dim of the shared expert path
    capacity_factor: float = 1.25  # dispatch buffer slack
    seq_chunk: int = 2048          # dispatch sequence chunk (bounds buffers)


@dataclass(frozen=True)
class ModelConfig:
    """Backbone architecture description.

    ``mixer_pattern`` is the repeating period of temporal-mixer kinds
    (``attn``: self-attention; ``xattn``: self-attention plus
    cross-attention to the image or encoder context; ``ssm``: the Mamba2
    SSD mixer, no MLP; ``rglru``: RecurrentGemma's RG-LRU mixer) and
    ``window_pattern`` the per-position attention window (0 = global).
    ``family``: dense | moe | ssm | hybrid | encoder (a bidirectional
    stack over frontend embeddings, no vocabulary) | vlm (a decoder cross-attending to
    projected image embeddings) | encdec (a decoder cross-attending to a
    nested ``encoder`` stack over ``encoder_seq`` frames).
    """
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    eos_id: Optional[int] = None
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072
    window_pattern: Tuple[int, ...] = (0,)
    mixer_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    # encoder-decoder: the nested encoder stack and its frame count
    encoder: Optional["ModelConfig"] = None
    encoder_seq: int = 0
    # vlm / encoder: patch tokens and their (stubbed) frontend width
    n_image_tokens: int = 0
    d_frontend: int = 0
    dtype: str = "bfloat16"
    head_pad: int = 1

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def n_heads_p(self) -> int:
        """q-heads padded to a multiple of ``head_pad``."""
        return _round_up(self.n_heads, self.head_pad)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.mixer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        w = self.window_pattern
        return tuple(w[i % len(w)] for i in range(self.n_layers))

    @property
    def d_inner(self) -> int:
        """The Mamba2 mixer's inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def n_params(self) -> int:
        """Approximate parameter count: embedding, blocks (an ``xattn``
        block counts its cross-attention, an ``ssm`` block has no MLP),
        head, the frontend projection ``in_proj`` and a nested encoder's
        blocks."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        n = V * D
        if not self.tie_embeddings:
            n += D * V
        qo = D * self.n_heads * self.d_head + self.n_heads * self.d_head * D
        kv = 2 * D * self.n_kv_heads * self.d_head
        mixer = {"attn": qo + kv, "xattn": 2 * (qo + kv)}
        if self.ssm_state:
            di, N = self.d_inner, self.ssm_state
            mixer["ssm"] = (D * (2 * di + 2 * N + self.n_ssm_heads) + di * D
                            + self.conv_kernel * (di + 2 * N))
        if self.lru_width:
            w = self.lru_width
            mixer["rglru"] = D * 2 * w + w * D + 2 * w * w \
                + self.conv_kernel * w
        if self.moe is not None:
            m = self.moe
            n_mlp = m.n_experts * 3 * D * m.d_expert + D * m.n_experts
            if m.n_shared_experts:
                n_mlp += 3 * D * m.d_shared
        else:
            n_mlp = (3 if self.act in ("swiglu", "geglu") else 2) * D * F
        for kind in self.layer_kinds:
            n += mixer.get(kind, mixer["attn"]) \
                + (n_mlp if kind != "ssm" else 0) + 2 * D
        if self.family in ("encoder", "vlm") or self.d_frontend:
            n += (self.d_frontend or D) * D
        if self.encoder is not None:     # its blocks and its in_proj
            n += self.encoder.n_params()
        return n


@dataclass(frozen=True)
class ElasticConfig:
    """Legacy elastic configuration; ``policy.as_spec_policy`` converts it
    to the (ElasticSpec, ElasticPolicy) pair the model consumes."""
    mlp_token_capacity: Optional[float] = 0.8
    mha_token_capacity: Optional[float] = None
    depth_capacity: Optional[float] = None
    mha_head_topk: Optional[int] = None
    mlp_n_experts: Optional[int] = None
    mlp_expert_topk: Optional[int] = None
    vlm_token_capacity: Optional[float] = None
    vlm_router: str = "linear"
    vlm_router_hidden: int = 0
    lora_rank: int = 0
    layers: str = "all"
    router_dtype: str = "float32"
    distill_loss: str = "topk_kl"
    distill_topk: int = 50
    distill_temp: float = 1.0
    lambda_load: float = 1.0
    lambda_topk: float = 1.0
    routing_impl: str = "ragged"
    kernel_backend: str = "auto"
    kv_dtype: str = "fp32"
    weight_dtype: str = "fp32"

    def applies_to_layer(self, idx: int) -> bool:
        return self.layers == "all" or idx % 2 == 0


REGISTRY: dict = {}


def register(name: str, full_fn, smoke_fn, elastic_fn=None):
    """``elastic_fn``: the arch's own elastic config (None: the port's
    default, see ``get_elastic``)."""
    REGISTRY[name] = {"full": full_fn, "smoke": smoke_fn,
                      "elastic": elastic_fn}


def get_config(name: str, variant: str = "full",
               head_pad: int = 1) -> ModelConfig:
    cfg = REGISTRY[name][variant]()
    if head_pad != cfg.head_pad:
        cfg = dataclasses.replace(cfg, head_pad=head_pad)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, head_pad=head_pad))
    return cfg


def get_elastic(name: str, cfg: Optional[ModelConfig] = None) -> ElasticConfig:
    """The arch's registered elastic config. An arch that registered none
    gets the port's default: token routing around attention and the MLP,
    head top-k, LoRA rank 1 and, for a VLM or encoder-decoder, the
    context-token selection at 0.6 (no experts, no depth routing)."""
    cfg = cfg or get_config(name)
    if REGISTRY[name]["elastic"] is not None:
        return REGISTRY[name]["elastic"](cfg)
    return ElasticConfig(mlp_token_capacity=0.8, mha_token_capacity=0.8,
                         mha_head_topk=max(1, cfg.n_heads // 2), lora_rank=1,
                         vlm_token_capacity=(0.6 if cfg.family in (
                             "vlm", "encdec") else None))
