"""Pluggable eviction policies: who leaves the device tier under pressure.

The manager computes the *candidate* set (persistent, spillable, not
pinned, not touched this round — see ``PoolManager._candidates``); the
policy only *orders* it, cheapest-to-evict first. This split keeps the
safety rules (never evict the live working set, never strand a family's
live pool owner) in one place while the cost model stays pluggable —
generalizing live-reference Master eviction.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List

from repro_torch.serving.pool.owners import EVICTION_RANK, OwnerInfo


@dataclass(frozen=True)
class EvictionCandidate:
    """One evictable owner, as seen by an :class:`EvictionPolicy`."""

    owner: str
    info: OwnerInfo
    n_pages: int
    last_used: int       # round index of the last touch (alloc/reload/use)


class EvictionPolicy(ABC):
    """Orders eviction candidates; the manager spills them in order until
    the pressure is relieved."""

    name: str = "?"

    @abstractmethod
    def order(self, cands: List[EvictionCandidate]) -> List[EvictionCandidate]:
        """Victim order, evict-first at the front."""


class LRUByRound(EvictionPolicy):
    """Coldest-first: evict the owner untouched for the most rounds.
    Ties break on the owner key for determinism."""

    name = "lru"

    def order(self, cands: List[EvictionCandidate]) -> List[EvictionCandidate]:
        return sorted(cands, key=lambda c: (c.last_used, c.owner))


class FamilyCostAware(EvictionPolicy):
    """Coldest-first, then cheapest-to-restore within an age class.

    Among equally-cold owners the family taxonomy orders the victims:
    mirror diff pages go before per-agent segment state, and a family's
    Master — the one dense cache every mirror restores against — leaves
    the device tier last. Masters are only ever *spilled* (the content
    survives on host); dropping a Master some session still references
    is impossible by construction, so a live family is never stranded.
    """

    name = "family"

    def order(self, cands: List[EvictionCandidate]) -> List[EvictionCandidate]:
        return sorted(
            cands,
            key=lambda c: (c.last_used,
                           EVICTION_RANK.get(c.info.kind, len(EVICTION_RANK)),
                           c.owner))


_POLICIES = {p.name: p for p in (LRUByRound, FamilyCostAware)}


def get_eviction_policy(name) -> EvictionPolicy:
    """Resolve an eviction policy from a name or pass an instance through."""
    if isinstance(name, EvictionPolicy):
        return name
    if name not in _POLICIES:
        raise KeyError(
            f"unknown eviction policy {name!r}; have {sorted(_POLICIES)}")
    return _POLICIES[name]()
