"""Qwen2.5-7B — the paper's smaller serving model [arXiv:2412.15115]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2412.15115",
)


def smoke_config() -> ModelConfig:
    # reduced same-family model used by the CPU serving benchmarks; keeps
    # the 7:1 q:kv head ratio and QKV bias of the full card.
    return CONFIG.replace(
        name="qwen2.5-7b-smoke",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=4096,
    )
