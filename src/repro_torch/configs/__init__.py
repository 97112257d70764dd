"""Config registry: importing this package registers the port's models."""
from repro_torch.configs.base import (
    REGISTRY, ElasticConfig, ModelConfig, get_config, register,
)
from repro_torch.configs import elasti_toy, qwen2_7b  # noqa: F401

__all__ = ["REGISTRY", "ElasticConfig", "ModelConfig", "get_config",
           "register"]
