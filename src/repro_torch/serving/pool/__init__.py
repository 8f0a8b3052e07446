"""Tiered KV pool manager: family-aware eviction, host offload, and
restore-ahead prefetch over :class:`~repro_torch.serving.kvpool.PagedKVPool`."""
from repro_torch.serving.pool.eviction import (EvictionCandidate,
                                               EvictionPolicy,
                                               FamilyCostAware, LRUByRound,
                                               get_eviction_policy)
from repro_torch.serving.pool.host import HostEntry, HostTier
from repro_torch.serving.pool.manager import (PoolLedger, PoolManager,
                                              Spillable)
from repro_torch.serving.pool.owners import (EVICTION_RANK, TRANSIENT_KINDS,
                                             OwnerInfo, family_owner,
                                             family_owners, hist_pool_owner,
                                             parse_owner)
from repro_torch.serving.pool.prefetch import PrefetchPlanner

__all__ = [
    "EVICTION_RANK", "TRANSIENT_KINDS", "EvictionCandidate", "EvictionPolicy",
    "FamilyCostAware", "HostEntry", "HostTier", "LRUByRound", "OwnerInfo",
    "PoolLedger", "PoolManager", "PrefetchPlanner", "Spillable",
    "family_owner", "family_owners", "get_eviction_policy",
    "hist_pool_owner", "parse_owner",
]
