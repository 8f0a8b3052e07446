"""Mamba2-2.7B — attention-free SSD state-space model [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        ssm_state=32,
        ssm_headdim=32,
    )
