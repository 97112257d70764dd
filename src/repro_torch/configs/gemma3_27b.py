"""gemma3-27b [dense] — 62L d=5376 32H (GQA kv=16) ff=21504 V=262144.

5 local (sliding window 1024) : 1 global attention, 128k context.
[hf:google/gemma-3 family]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        d_ff=21504, vocab_size=262144, d_head=128,
        act="geglu", norm="rmsnorm", rope_theta=1_000_000.0,
        window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
        max_seq_len=524_288, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512, d_head=16,
        act="geglu", norm="rmsnorm",
        window_pattern=(16, 0), tie_embeddings=True,
    )


register("gemma3-27b", full, smoke)
