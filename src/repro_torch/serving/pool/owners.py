"""Owner taxonomy for the tiered pool manager.

Every :class:`~repro_torch.serving.kvpool.PagedKVPool` allocation is keyed by
a well-known owner string (see the pool's class docstring). The manager
needs to *understand* those keys — what kind of state a page backs and
how expensive losing it is — so eviction can order victims by restore
cost instead of treating the pool as a flat byte bucket:

  ``td:mirrors:<fam>``   block-sparse diff pages: cheapest to re-obtain
                         (small, and regenerated at every store anyway)
  ``out:<aid>``          one agent's output segment (G tokens)
  ``hist:<aid>``         one agent's dense history entry (pic baseline)
  ``hist:family:<fam>``  the family's PERSISTENT cross-round restore pool
                         (incremental restore): survives rounds, spillable,
                         losing it costs one full family restore
  ``sess:<aid>``         one agent's dense prefix cache (prefix baseline)
  ``td:master:<fam>``    the family's ONE dense cache: most expensive —
                         losing it strands every mirror of the family
  ``restore:family:<g>`` the in-flight restore page pool (transient;
                         referenced by live ``PagedSegmentCacheEntry``s)
  ``round:<aid>``        the round-transient decode working set

Transient owners (``restore:family``, ``round``) are never eviction
candidates: their pages are the current round's working set and may be
referenced by live paged cache entries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

#: kinds orderable by eviction cost (lower rank = evict first); kinds
#: absent from this map are never selected as victims
EVICTION_RANK = {
    "mirrors": 0,
    "out": 1,
    "hist": 1,
    "histpool": 1,
    "sess": 1,
    "master": 2,
}

#: owner kinds whose pages belong to the current round's working set
TRANSIENT_KINDS = frozenset({"restore", "round"})

_PREFIXES = (
    ("td:master:", "master"),
    ("td:mirrors:", "mirrors"),
    ("restore:family:", "restore"),
    ("hist:family:", "histpool"),   # must precede the "hist:" prefix
    ("hist:", "hist"),
    ("out:", "out"),
    ("sess:", "sess"),
    ("round:", "round"),
)


@dataclass(frozen=True)
class OwnerInfo:
    """Parsed owner key: the state class plus its family/agent suffix."""

    kind: str   # one of the taxonomy kinds above, or "other"
    key: str    # family-owner suffix ("a0+a1") or agent id

    @property
    def transient(self) -> bool:
        return self.kind in TRANSIENT_KINDS

    @property
    def rank(self) -> Optional[int]:
        """Eviction cost rank (evict-first = 0) or None (never evict)."""
        return EVICTION_RANK.get(self.kind)


def parse_owner(owner: str) -> OwnerInfo:
    """Classify a pool owner key into the serving taxonomy."""
    for prefix, kind in _PREFIXES:
        if owner.startswith(prefix):
            return OwnerInfo(kind, owner[len(prefix):])
    return OwnerInfo("other", owner)


def family_owner(group_key: Sequence[str]) -> str:
    """Stable pool-owner suffix for a Master family (the reverse of the
    ``td:master:<fam>`` / ``td:mirrors:<fam>`` key scheme)."""
    return "+".join(group_key)


def family_owners(group_key: Sequence[str]) -> tuple:
    """The two persistent pool owners a Master family allocates."""
    fam = family_owner(group_key)
    return (f"td:master:{fam}", f"td:mirrors:{fam}")


def hist_pool_owner(group_key: Sequence[str]) -> str:
    """The persistent cross-round restore-pool owner of a Master family
    (incremental restore; see ``serving/pool/histpool.py``)."""
    return f"hist:family:{family_owner(group_key)}"
