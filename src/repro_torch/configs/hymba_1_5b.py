"""Hymba-1.5B — hybrid parallel attention + Mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    hybrid=True,
    sliding_window=1024,  # hymba uses SWA on most layers; enables long_500k
    source="arXiv:2411.13676",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="hymba-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_headdim=32,
        sliding_window=64,
    )
