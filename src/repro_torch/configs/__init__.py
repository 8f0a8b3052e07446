from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config",
           "list_archs"]
