"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) ff=14336 V=128256.

A cross-attention image layer every 5th layer; the vision frontend is a
stub: the model takes precomputed patch embeddings (1601 x 1280) and
projects them with ``in_proj``. [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, d_head=128,
        act="swiglu", norm="rmsnorm", rope_theta=500_000.0,
        mixer_pattern=("attn", "attn", "attn", "attn", "xattn"),
        n_image_tokens=1601, d_frontend=1280,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=512, d_head=16,
        act="swiglu", norm="rmsnorm",
        mixer_pattern=("attn", "attn", "attn", "attn", "xattn"),
        n_image_tokens=16, d_frontend=32,
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    # paper §5.3: image-token subset selection before the language decoder
    return ElasticConfig(
        mlp_token_capacity=0.8, mha_token_capacity=0.8,
        mha_head_topk=cfg.n_heads // 2, mlp_n_experts=16, mlp_expert_topk=9,
        vlm_token_capacity=0.6, vlm_router="linear", lora_rank=1,
    )


register("llama-3.2-vision-11b", full, smoke, elastic)
