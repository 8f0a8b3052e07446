"""Gemma-3 12B — dense, 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt family card]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_layer_interval=6,  # 5 local : 1 global
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-12b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=64,
        global_layer_interval=2,
    )
