"""Gemma-3 1B — dense, 5:1 local:global sliding window [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    sliding_window=512,
    global_layer_interval=6,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-1b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=64,
        global_layer_interval=2,
    )
