"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) V=151936, QKV bias.

60 routed experts (top-4, d_expert=1408) + a shared path of width 5632.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import (ElasticConfig, ModelConfig, MoEConfig,
                                      register)


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936, d_head=128,
        act="swiglu", norm="rmsnorm", qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                      n_shared_experts=4, d_shared=5632),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=48, vocab_size=512, d_head=16,
        act="swiglu", norm="rmsnorm", qkv_bias=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48,
                      n_shared_experts=1, d_shared=96, seq_chunk=32),
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    # native MoE: the param-subset router drives the existing experts
    # (elastic top-k); no moefy needed
    return ElasticConfig(
        mlp_token_capacity=0.8, mha_token_capacity=0.8,
        mha_head_topk=cfg.n_heads // 2,
        mlp_n_experts=None, mlp_expert_topk=cfg.moe.top_k,
        lora_rank=1,
    )


register("qwen2-moe-a2.7b", full, smoke, elastic)
