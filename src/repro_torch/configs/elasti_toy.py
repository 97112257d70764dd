"""The paper-scale toy causal LM the tests use (trainable on a CPU)."""
from repro_torch.configs.base import ModelConfig, register


def toy_lm(n_layers=4, d_model=128, n_heads=4, d_ff=352, vocab=2048) -> ModelConfig:
    return ModelConfig(
        name="toy-lm", family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab_size=vocab, d_head=d_model // n_heads,
        act="swiglu", norm="rmsnorm", tie_embeddings=True,
    )


register("toy-lm", toy_lm, toy_lm)
