"""Grok-1 314B — MoE, 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    attn_logit_softcap=30.0,
    long_context_window=8192,  # beyond-paper: SWA variant for long_500k
    source="hf:xai-org/grok-1",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="grok-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        # Dropless capacity for the smoke regime: moe_block's capacity
        # C = ceil(tg*K/E * cf) is a function of the flattened token-group
        # size tg, so with the default cf=1.25 a full forward (tg=32,
        # C=20) DROPS overflow tokens that incremental decode (tg=2, C=8,
        # never saturated) computes — decode legitimately diverged from
        # forward whenever the untrained router crowded one expert
        # (the old test_decode_matches_forward[grok-1-314b] seed failure).
        # cf=E makes C = tg*K >= the worst-case per-expert demand (each
        # token adds at most 1 per expert), so no path drops and the
        # prefill/decode parity invariant holds. The full config keeps
        # published capacity semantics.
        capacity_factor=4.0,
        top_k=2,
    )
