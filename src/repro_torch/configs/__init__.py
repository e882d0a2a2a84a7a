from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    AttentionConfig,
    EncoderConfig,
    InputShape,
    LoRAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "AttentionConfig",
    "EncoderConfig",
    "InputShape",
    "LoRAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "get_config",
    "reduced_config",
]
