"""mamba2-780m [ssm] — 48L d=1536 attn-free, SSD state=128. [arXiv:2405.21060]

ElastiFormer head/expert routing is inapplicable to the SSD mixer (documented
in DESIGN.md §Arch-applicability); token routing around blocks applies.
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280, d_head=0,
        norm="rmsnorm", mixer_pattern=("ssm",),
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        tie_embeddings=True, max_seq_len=1_048_576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512, d_head=0,
        norm="rmsnorm", mixer_pattern=("ssm",),
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
        tie_embeddings=True,
    )


def elastic(cfg: ModelConfig) -> ElasticConfig:
    # attn-free: only input-subset selection applies (around SSD mixer blocks).
    return ElasticConfig(
        mlp_token_capacity=None, mha_token_capacity=0.8,
        mha_head_topk=None, mlp_n_experts=None, mlp_expert_topk=None,
        lora_rank=0,
    )


register("mamba2-780m", full, smoke, elastic)
