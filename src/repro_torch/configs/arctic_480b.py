"""Snowflake Arctic 480B — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="hf:Snowflake/snowflake-arctic-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="arctic-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        dense_residual=True,
    )
