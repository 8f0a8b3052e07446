"""Policy-object serving API of the port, with the registry of mode
strings (``get_policy``) behind the engine's string argument and the
deprecated ``MultiAgentEngine(mode=...)`` shim."""
from repro_torch.serving.policies.base import (POLICIES, PolicyRuntime,
                                               RecoveryPlan, RecoveryResult,
                                               ReusePolicy, RoundContext,
                                               get_policy, register_policy)
from repro_torch.serving.policies.pic import PICPolicy
from repro_torch.serving.policies.prefix import PrefixCachePolicy
from repro_torch.serving.policies.recompute import RecomputePolicy
from repro_torch.serving.policies.tokendance import TokenDancePolicy

__all__ = ["POLICIES", "PICPolicy", "PolicyRuntime", "PrefixCachePolicy",
           "RecomputePolicy", "RecoveryPlan", "RecoveryResult",
           "ReusePolicy", "RoundContext", "TokenDancePolicy", "get_policy",
           "register_policy"]
