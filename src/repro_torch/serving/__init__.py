"""Serving layer of the port: the round engine, the reuse policies and the
tiered KV pool."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvpool import Allocation, PagedKVPool, PoolExhausted
from repro_torch.serving.policies import (PICPolicy, PolicyRuntime,
                                          RecoveryPlan, RecoveryResult,
                                          ReusePolicy, RoundContext,
                                          TokenDancePolicy)
from repro_torch.serving.pool import (HostTier, PoolLedger, PoolManager,
                                      Spillable)
from repro_torch.serving.round_kv import PagedRoundKV, round_kv
from repro_torch.serving.state import RoundStats, Session

__all__ = ["Allocation", "HostTier", "PICPolicy", "PagedKVPool",
           "PagedRoundKV", "PolicyRuntime", "PoolExhausted", "PoolLedger",
           "PoolManager", "RecoveryPlan", "RecoveryResult", "ReusePolicy",
           "RoundContext", "RoundStats", "ServingEngine", "Session",
           "Spillable", "TokenDancePolicy", "round_kv"]
