"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) ff=7680 V=256000.

RG-LRU + local attention, pattern (rglru, rglru, attn). [arXiv:2402.19427]
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab_size=256000, d_head=256,
        act="geglu", norm="rmsnorm",
        mixer_pattern=("rglru", "rglru", "attn"),
        window_pattern=(0, 0, 2048),   # attention layers use local window 2048
        lru_width=2560, conv_kernel=4,
        tie_embeddings=True, max_seq_len=1_048_576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=192, vocab_size=512, d_head=16,
        act="geglu", norm="rmsnorm",
        mixer_pattern=("rglru", "rglru", "attn"),
        window_pattern=(0, 0, 16),
        lru_width=64, conv_kernel=4, tie_embeddings=True,
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    return ElasticConfig(
        mlp_token_capacity=0.8, mha_token_capacity=0.8,
        mha_head_topk=cfg.n_heads // 2, mlp_n_experts=16, mlp_expert_topk=9,
        lora_rank=1,
    )


register("recurrentgemma-2b", full, smoke, elastic)
