"""vLLM-without-reuse baseline: full batched prefill every round."""
from __future__ import annotations

import torch

from repro_torch.serving.policies.base import (RecoveryPlan, RecoveryResult,
                                               ReusePolicy, RoundContext,
                                               register_policy)


@register_policy("recompute")
class RecomputePolicy(ReusePolicy):
    """No reuse: every round pays one full batched prefill. Keeps no
    per-agent cache state, so ``store`` is a no-op — this is also the
    policy SSM/hybrid architectures are served with."""

    def plan(self, ctx: RoundContext) -> RecoveryPlan:
        return RecoveryPlan(kind="recompute", ctx=ctx)

    def recover(self, plan: RecoveryPlan,
                tokens: torch.Tensor) -> RecoveryResult:
        return self._recover_recompute(tokens)
