"""whisper-medium [audio] — enc-dec, 24L each, d=1024 16H ff=4096 V=51865.

The conv frontend is a stub: the model takes precomputed frame embeddings
(B, encoder_seq, d_model). [arXiv:2212.04356]
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig, register


def _encoder(d, layers, heads, ff, seq):
    return ModelConfig(
        name="whisper-enc", family="encoder",
        n_layers=layers, d_model=d, n_heads=heads, n_kv_heads=heads,
        d_ff=ff, vocab_size=0, d_head=d // heads,
        act="gelu", norm="layernorm", qkv_bias=True,
        mixer_pattern=("attn",), encoder_seq=seq,
    )


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865, d_head=64,
        act="gelu", norm="layernorm", qkv_bias=True,
        mixer_pattern=("xattn",),          # every decoder layer cross-attends
        encoder=_encoder(1024, 24, 16, 4096, 1500),
        encoder_seq=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=192, vocab_size=512, d_head=16,
        act="gelu", norm="layernorm", qkv_bias=True,
        mixer_pattern=("xattn",),
        encoder=_encoder(64, 2, 4, 192, 24),
        encoder_seq=24,
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    # encoder-output token selection before cross-attention: the paper's
    # image-token selection applied to audio frames
    return ElasticConfig(
        mlp_token_capacity=0.8, mha_token_capacity=0.8,
        mha_head_topk=cfg.n_heads // 2, mlp_n_experts=16, mlp_expert_topk=9,
        vlm_token_capacity=0.6, lora_rank=1,
    )


register("whisper-medium", full, smoke, elastic)
