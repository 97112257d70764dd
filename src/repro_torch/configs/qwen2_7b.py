"""qwen2-7b [dense] — 28L d=3584 28H (GQA kv=4) ff=18944 V=152064, QKV bias.

[arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, d_head=128,
        act="swiglu", norm="rmsnorm", qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=176, vocab_size=512, d_head=16,
        act="swiglu", norm="rmsnorm", qkv_bias=True,
    )


register("qwen2-7b", full, smoke)
