"""granite-34b [dense] — 88L d=6144 48H (MQA kv=1) ff=24576 V=49152.

Llama-style code model with multi-query attention. [arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, d_head=128,
        act="gelu", norm="layernorm", qkv_bias=True, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=192, vocab_size=512, d_head=16,
        act="gelu", norm="layernorm", qkv_bias=True,
    )


register("granite-34b", full, smoke)
