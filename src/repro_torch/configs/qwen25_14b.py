"""Qwen2.5-14B — the paper's larger serving model [arXiv:2412.15115]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2412.15115",
)


def smoke_config() -> ModelConfig:
    # "larger model" stand-in for CPU benchmarks: 2x the layers/width of the
    # 7b smoke so compression-vs-model-size trends (paper Fig. 12) show up.
    return CONFIG.replace(
        name="qwen2.5-14b-smoke",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=2,
        head_dim=64,
        d_ff=1024,
        vocab_size=4096,
    )
