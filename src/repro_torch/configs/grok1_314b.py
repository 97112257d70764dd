"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) V=131072, 8 experts top-2,
d_expert=32768. [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import (ElasticConfig, ModelConfig, MoEConfig,
                                      register)


def full() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab_size=131072, d_head=128,
        act="geglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, seq_chunk=1024),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=512, d_head=16,
        act="geglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, seq_chunk=32),
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    return ElasticConfig(
        mlp_token_capacity=0.8, mha_token_capacity=0.8,
        mha_head_topk=cfg.n_heads // 2,
        mlp_n_experts=None, mlp_expert_topk=cfg.moe.top_k,
        lora_rank=1,
    )


register("grok-1-314b", full, smoke, elastic)
