"""Qwen2-72B — dense, GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
