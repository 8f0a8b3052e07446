from repro_torch.models.transformer import (
    decode_step_paged,
    from_jax,
    init_params,
    prefill,
)

__all__ = ["decode_step_paged", "from_jax", "init_params", "prefill"]
