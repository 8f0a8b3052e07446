"""Training on the port: synthetic data, AdamW, the loss and the loop —
the JAX package's ``repro.training``, with ``checkpoint`` beside it."""
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
    lr_at,
)
from repro_torch.training.train_loop import (TrainResult, loss_fn,
                                             make_train_step, train)

__all__ = [
    "DataConfig",
    "SyntheticTokens",
    "AdamWConfig",
    "AdamWState",
    "adamw_update",
    "init_adamw",
    "lr_at",
    "TrainResult",
    "loss_fn",
    "make_train_step",
    "train",
]
