"""Qwen3-4B — dense, GQA, qk-norm [hf:Qwen/Qwen3-8B family card]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
