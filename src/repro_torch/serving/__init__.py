"""Serving layer of the port: the round engine, the reuse policies and the
tiered KV pool."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvpool import Allocation, PagedKVPool, PoolExhausted
from repro_torch.serving.planner import RoundPlan
from repro_torch.serving.policies import (POLICIES, PICPolicy,
                                          PolicyRuntime, RecomputePolicy,
                                          RecoveryPlan, RecoveryResult,
                                          ReusePolicy, RoundContext,
                                          TokenDancePolicy, get_policy)
from repro_torch.serving.pool import (HostTier, PoolLedger, PoolManager,
                                      Spillable)
from repro_torch.serving.round_kv import (DenseRoundKV, PagedRoundKV,
                                          round_kv)
from repro_torch.serving.state import RoundStats, Session

__all__ = ["Allocation", "DenseRoundKV", "HostTier", "POLICIES", "PICPolicy",
           "PagedKVPool", "PagedRoundKV", "PolicyRuntime", "PoolExhausted",
           "PoolLedger", "PoolManager", "RecomputePolicy", "RecoveryPlan",
           "RecoveryResult", "ReusePolicy", "RoundContext", "RoundPlan",
           "RoundStats",
           "ServingEngine", "Session", "Spillable", "TokenDancePolicy",
           "get_policy", "round_kv"]
