"""Chameleon-34B — early-fusion VLM over VQ image tokens [arXiv:2405.09818].
Backbone only; the VQ-VAE image tokenizer / vision frontend is stubbed
(precomputed patch-token embeddings), per the brief.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,  # chameleon uses qk-norm for training stability
    frontend="vision",
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="arXiv:2405.09818",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="chameleon-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
