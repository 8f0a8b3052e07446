"""MusicGen-large — decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284]. Backbone only; the EnCodec frontend is stubbed
(precomputed frame embeddings), per the brief.

Deviation: the published model uses sinusoidal position embeddings; we use
RoPE so the PIC realignment path is uniform (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="arXiv:2306.05284",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
