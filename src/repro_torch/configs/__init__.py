"""Config registry: importing this package registers the port's models."""
from repro_torch.configs.base import (
    REGISTRY, ElasticConfig, ModelConfig, MoEConfig, get_config, get_elastic,
    register,
)
from repro_torch.configs import (  # noqa: F401
    elasti_toy, llama32_vision_11b, qwen2_7b, qwen2_moe_a2p7b, whisper_medium,
)

__all__ = ["REGISTRY", "ElasticConfig", "ModelConfig", "MoEConfig",
           "get_config", "get_elastic", "register"]
