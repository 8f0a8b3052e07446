"""Restore-ahead prefetch: turn the round plan for round r+1 into the
pool owners whose device residency the restore path will need, so their
host→device reload overlaps round r's decode (KVFlow's
steps-to-execution prefetch, TokenCake's time scheduler).

The planner is deliberately dumb: the *admission plan already knows* the
future. ``RoundPlanner`` emits the round r+1 admitted set during round r
(the engine plans one round ahead); each admitted agent's session names
the family it was compressed in; the family names its two persistent
pool owners plus each member's output segment. Agents also admitted in
round r are excluded — their family state is re-formed by round r's
``store`` anyway, so reloading a stale spilled copy would be wasted
transfer.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from repro_torch.serving.pool.owners import family_owners, hist_pool_owner


class PrefetchPlanner:
    """Maps a next-round admission set onto reload-candidate owners."""

    def owners_for(self, sessions: Dict[str, object],
                   next_admitted: Iterable[str],
                   exclude: Iterable[str] = ()) -> List[str]:
        """Pool owners round r+1's restore will touch, dedup'd in a
        stable order: for each newly-(re)admitted agent, its family's
        Master and mirror-diff owners plus its own output segment."""
        exclude = set(exclude)
        owners: List[str] = []
        seen = set()
        for a in next_admitted:
            if a in exclude:
                continue
            s = sessions.get(a)
            fam = getattr(s, "family", None) if s is not None else None
            if fam is not None and fam not in seen:
                seen.add(fam)
                owners.extend(family_owners(fam))
                # the family's cross-round restore pool (incremental
                # restore) — reloading it ahead of plan() turns the
                # prefix-page reuse's residency check into a hit
                owners.append(hist_pool_owner(fam))
            out = f"out:{a}"
            if out not in seen:
                seen.add(out)
                owners.append(out)
        return owners
