"""Config registry: importing this package registers the port's models."""
from repro_torch.configs.base import (
    REGISTRY, ElasticConfig, ModelConfig, MoEConfig, get_config, get_elastic,
    register,
)
from repro_torch.configs import (  # noqa: F401
    elasti_toy, gemma3_27b, granite_34b, grok1_314b, llama32_vision_11b,
    mamba2_780m, phi3_medium_14b, qwen2_7b, qwen2_moe_a2p7b,
    recurrentgemma_2b, whisper_medium,
)

__all__ = ["REGISTRY", "ElasticConfig", "ModelConfig", "MoEConfig",
           "get_config", "get_elastic", "register"]
