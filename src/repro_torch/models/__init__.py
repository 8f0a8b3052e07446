from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    extend,
    forward,
    from_jax,
    init_params,
    make_empty_cache,
    prefill,
)

__all__ = ["decode_step", "decode_step_paged", "extend", "forward",
           "from_jax", "init_params", "make_empty_cache", "prefill"]
