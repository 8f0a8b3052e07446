"""Serving layer of the port: the round engine, the reuse policies, the
SLO planner and capacity model, the continuous loop and the tiered KV
pool."""
from repro_torch.serving.engine import MODES, MultiAgentEngine, ServingEngine
from repro_torch.serving.kvpool import Allocation, PagedKVPool, PoolExhausted
from repro_torch.serving.loop import (ContinuousEngine, ContinuousResult,
                                      Phase, PhaseCost, StepEvent,
                                      StepScheduler, WorkItem)
from repro_torch.serving.planner import RoundPlan, RoundPlanner
from repro_torch.serving.policies import (POLICIES, PICPolicy,
                                          PolicyRuntime, PrefixCachePolicy,
                                          RecomputePolicy, RecoveryPlan,
                                          RecoveryResult, ReusePolicy,
                                          RoundContext, TokenDancePolicy,
                                          get_policy, register_policy)
from repro_torch.serving.pool import (EvictionPolicy, FamilyCostAware,
                                      HostTier, LRUByRound, PoolLedger,
                                      PoolManager, PrefetchPlanner,
                                      Spillable, get_eviction_policy)
from repro_torch.serving.round_kv import (DenseRoundKV, PagedRoundKV,
                                          round_kv)
from repro_torch.serving.scheduler import (ServiceTimes,
                                           max_agents_under_slo,
                                           service_times_from_stats,
                                           simulate_round_latency)
from repro_torch.serving.state import RoundStats, Session

__all__ = [
    # engine
    "MODES", "MultiAgentEngine", "ServingEngine", "RoundStats", "Session",
    # policies
    "POLICIES", "PICPolicy", "PolicyRuntime", "PrefixCachePolicy",
    "RecomputePolicy", "RecoveryPlan", "RecoveryResult", "ReusePolicy",
    "RoundContext", "TokenDancePolicy", "get_policy", "register_policy",
    # planner + capacity model
    "RoundPlan", "RoundPlanner", "ServiceTimes", "max_agents_under_slo",
    "service_times_from_stats", "simulate_round_latency",
    # pool
    "Allocation", "PagedKVPool", "PoolExhausted", "EvictionPolicy",
    "FamilyCostAware", "HostTier", "LRUByRound", "PoolLedger",
    "PoolManager", "PrefetchPlanner", "Spillable", "get_eviction_policy",
    # round-KV views
    "DenseRoundKV", "PagedRoundKV", "round_kv",
    # continuous serving loop
    "ContinuousEngine", "ContinuousResult", "Phase", "PhaseCost",
    "StepEvent", "StepScheduler", "WorkItem",
]
