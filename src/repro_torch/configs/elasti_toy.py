"""Paper-scale toy configs the tests use (trainable on a CPU): the causal
LM, the ViT encoder and the VLM."""
from repro_torch.configs.base import ModelConfig, register


def toy_lm(n_layers=4, d_model=128, n_heads=4, d_ff=352, vocab=2048) -> ModelConfig:
    return ModelConfig(
        name="toy-lm", family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab_size=vocab, d_head=d_model // n_heads,
        act="swiglu", norm="rmsnorm", tie_embeddings=True,
    )


def toy_vit(n_layers=4, d_model=128, n_heads=4, d_ff=352, n_patches=64) -> ModelConfig:
    # a bidirectional encoder over patch embeddings (no vocabulary)
    return ModelConfig(
        name="toy-vit", family="encoder",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab_size=0, d_head=d_model // n_heads,
        act="gelu", norm="layernorm",
        n_image_tokens=n_patches, d_frontend=d_model,
    )


def toy_vlm(n_layers=4, d_model=128, n_heads=4, d_ff=352, vocab=2048,
            n_image_tokens=32) -> ModelConfig:
    return ModelConfig(
        name="toy-vlm", family="vlm",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab_size=vocab, d_head=d_model // n_heads,
        act="swiglu", norm="rmsnorm", tie_embeddings=True,
        mixer_pattern=("attn", "xattn"),
        n_image_tokens=n_image_tokens, d_frontend=64,
    )


register("toy-lm", toy_lm, toy_lm)
register("toy-vit", toy_vit, toy_vit)
register("toy-vlm", toy_vlm, toy_vlm)
