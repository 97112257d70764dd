"""Config registry: importing this package registers the port's models."""
from repro_torch.configs.base import (
    REGISTRY, ElasticConfig, ModelConfig, MoEConfig, get_config, get_elastic,
    register,
)
from repro_torch.configs import elasti_toy, qwen2_7b, qwen2_moe_a2p7b  # noqa: F401

__all__ = ["REGISTRY", "ElasticConfig", "ModelConfig", "MoEConfig",
           "get_config", "get_elastic", "register"]
