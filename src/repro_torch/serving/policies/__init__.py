"""Policy-object serving API of the port."""
from repro_torch.serving.policies.base import (PolicyRuntime, RecoveryPlan,
                                               RecoveryResult, ReusePolicy,
                                               RoundContext)
from repro_torch.serving.policies.pic import PICPolicy
from repro_torch.serving.policies.tokendance import TokenDancePolicy

__all__ = ["PICPolicy", "PolicyRuntime", "RecoveryPlan", "RecoveryResult",
           "ReusePolicy", "RoundContext", "TokenDancePolicy"]
