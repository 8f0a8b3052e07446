"""Tiered pool manager: pressure-aware allocation over :class:`PagedKVPool`.

``PagedKVPool`` is a flat page allocator — when the free list runs dry it
raises :class:`PoolExhausted` and the round dies. The manager layers the
three mechanisms that turn that hard wall into graceful degradation:

1. **Family-aware eviction.** Allocation failures trigger
   :meth:`_make_room`: persistent owners that registered a
   :class:`Spillable` and were not touched this round are spilled to the
   host tier in :class:`EvictionPolicy` order (mirror diffs before
   per-agent segments before Masters). Transient owners
   (``restore:family:*``, ``round:*``) are never candidates — their
   pages are the live working set and may be referenced by
   ``PagedSegmentCacheEntry`` objects — and eviction only ever *spills*
   (content survives on host), so a family's live pool owner is never
   stranded.

2. **Host tier.** Spilling moves the owning objects' tensors to the CPU
   in place (via the registered :class:`Spillable`) and frees the device
   pages; reloading moves them back to the manager's device and
   re-claims pages.
   The round trip is bit-exact by construction — no re-quantisation, no
   re-compression — and every byte moved lands in the :class:`PoolLedger`.

3. **Restore-ahead prefetch.** :meth:`prefetch` reloads a set of owners
   ahead of use (the engine derives the set from round r+1's admission
   plan while round r decodes); :meth:`ensure_resident` at the consumer
   then counts a ``prefetch_hit`` instead of a ``sync_reload``.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.serving.kvpool import PagedKVPool, PoolExhausted
from repro_torch.serving.pool.eviction import (EvictionCandidate, EvictionPolicy,
                                         get_eviction_policy)
from repro_torch.serving.pool.host import HostEntry, HostTier
from repro_torch.serving.pool.owners import parse_owner
from repro_torch.serving.pool.prefetch import PrefetchPlanner


@dataclass
class Spillable:
    """How to move one owner's backing arrays between tiers.

    ``get`` returns the arrays as currently stored in the owning objects
    (``MasterCache.k/v``, ``MirrorDiff.k_vals/v_vals``, a segment
    entry's ``k/v`` …); ``put`` writes converted arrays back into those
    same slots. Spill = ``put(x.cpu() for x in get())``, reload =
    ``put(x.to(device) for x in get())`` — the consumer-side code never
    sees a third representation.
    """

    get: Callable[[], Sequence[Any]]
    put: Callable[[Sequence[Any]], None]


#: scope bucket used when no committee scope is active on the manager
DEFAULT_SCOPE = "engine"


@dataclass
class PoolLedger:
    """Byte/event accounting for tier traffic (the §5 'swap' columns).

    Counters are kept twice: once globally (the flat :meth:`snapshot`
    face the benchmarks read) and once per *scope* — the committee whose
    phase triggered the traffic (``PoolManager.scope``, gather-group id
    ``g<c>``; :data:`DEFAULT_SCOPE` when no committee is active). Every
    :meth:`bump` lands in exactly one scope, so the per-scope counters
    always sum to the globals (checked by :meth:`PoolManager.check`) and
    multi-committee stats never blend into one aggregate.
    """

    spill_events: int = 0
    spilled_bytes: int = 0
    spilled_pages: int = 0
    reload_events: int = 0
    reloaded_bytes: int = 0
    reloaded_pages: int = 0
    #: reloads that blocked a consumer (owner was cold at use time)
    sync_reloads: int = 0
    #: reloads issued ahead of use by :meth:`PoolManager.prefetch`
    prefetched_reloads: int = 0
    #: consumer touches that found the owner already prefetched
    prefetch_hits: int = 0
    #: per-committee breakdown of the same counters (scope → counter → n)
    scopes: Dict[str, Dict[str, int]] = field(default_factory=dict)

    _COUNTERS = ("spill_events", "spilled_bytes", "spilled_pages",
                 "reload_events", "reloaded_bytes", "reloaded_pages",
                 "sync_reloads", "prefetched_reloads", "prefetch_hits")

    def bump(self, scope: Optional[str], **deltas: int) -> None:
        """Advance counters globally AND in ``scope``'s bucket."""
        bucket = self.scopes.setdefault(scope or DEFAULT_SCOPE, {})
        for k, d in deltas.items():
            setattr(self, k, getattr(self, k) + d)
            bucket[k] = bucket.get(k, 0) + d

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self._COUNTERS}

    def delta(self, prev: Dict[str, int]) -> Dict[str, int]:
        """Counters advanced since ``prev`` (a :meth:`snapshot`), nonzero
        entries only — merged into ``RoundStats`` per round."""
        now = self.snapshot()
        return {k: now[k] - prev.get(k, 0)
                for k in now if now[k] != prev.get(k, 0)}

    def scoped_snapshot(self) -> Dict[str, Dict[str, int]]:
        return {s: dict(b) for s, b in self.scopes.items()}

    def scoped_delta(self, prev: Dict[str, Dict[str, int]]
                     ) -> Dict[str, Dict[str, int]]:
        """Per-scope counters advanced since a :meth:`scoped_snapshot`,
        nonzero entries only — the ``by_committee`` breakdown in
        ``stats.reuse["pool"]``."""
        out: Dict[str, Dict[str, int]] = {}
        for s, bucket in self.scopes.items():
            p = prev.get(s, {})
            d = {k: v - p.get(k, 0) for k, v in bucket.items()
                 if v != p.get(k, 0)}
            if d:
                out[s] = d
        return out

    def check_scopes(self) -> None:
        """Per-scope counters must sum exactly to the globals — a bump
        that bypassed :meth:`bump` (or double-counted a scope) shows up
        here."""
        for k in self._COUNTERS:
            total = sum(b.get(k, 0) for b in self.scopes.values())
            assert total == getattr(self, k), \
                f"ledger scope split broken for {k}: " \
                f"sum(scopes)={total} != global={getattr(self, k)}"


class PoolManager:
    """Eviction + host offload + prefetch over a :class:`PagedKVPool`."""

    def __init__(self, pool: PagedKVPool, *,
                 device=None,
                 eviction="family",
                 host: Optional[HostTier] = None,
                 prefetch: Optional[PrefetchPlanner] = None):
        self.pool = pool
        #: where resident owners' tensors live (reload target)
        self.device = torch.device(device) if device is not None else None
        self.eviction: EvictionPolicy = get_eviction_policy(eviction)
        self.host = host if host is not None else HostTier()
        self.prefetch_planner = prefetch if prefetch is not None else PrefetchPlanner()
        self.ledger = PoolLedger()
        self.round_idx = 0
        #: active committee scope for ledger attribution (gather-group id);
        #: None books to :data:`DEFAULT_SCOPE`
        self.scope: Optional[str] = None
        #: rounds a prefetch stays warm before :meth:`begin_round` expires
        #: it. 1 (default) matches the synchronized engine's one-round
        #: lookahead; the continuous engine raises it to ~n_committees
        #: because its ``begin_round`` clock ticks once per committee-round
        #: start, not once per global round.
        self.prefetch_ttl = 1
        self._spillables: Dict[str, Spillable] = {}
        self._last_used: Dict[str, int] = {}
        self._pinned: set = set()
        #: owners reloaded ahead of use → round the prefetch was issued
        self._prefetched: Dict[str, int] = {}

    @contextmanager
    def scoped(self, scope: Optional[str]):
        """Attribute all ledger traffic inside the block to ``scope``."""
        prev = self.scope
        self.scope = scope
        try:
            yield
        finally:
            self.scope = prev

    # --------------------------------------------------------- allocation
    def alloc(self, owner: str, n_pages: int, *, persistent: bool,
              spillable: Optional[Spillable] = None):
        """Allocate device pages, evicting cold owners on pressure.

        An owner currently spilled to host must be :meth:`free`'d or
        :meth:`reload`'ed first — allocating over it would fork the
        state across tiers.
        """
        assert owner not in self.host, \
            f"{owner} is spilled to host; reload() or free() it before alloc()"
        try:
            a = self.pool.alloc(owner, n_pages, persistent=persistent)
        except PoolExhausted:
            self._make_room(n_pages)
            a = self.pool.alloc(owner, n_pages, persistent=persistent)
        if spillable is not None:
            self._spillables[owner] = spillable
        self.touch(owner)
        return a

    def alloc_tokens(self, owner: str, n_tokens: int, *, persistent: bool,
                     spillable: Optional[Spillable] = None):
        return self.alloc(owner, self.pool.pages_for_tokens(n_tokens),
                          persistent=persistent, spillable=spillable)

    def append_page(self, owner: str) -> int:
        """Grow an existing allocation by one page (the decode loop's
        per-block-boundary claim), evicting cold owners on pressure like
        :meth:`alloc`."""
        try:
            page = self.pool.append_page(owner)
        except PoolExhausted:
            self._make_room(1)
            page = self.pool.append_page(owner)
        self.touch(owner)
        return page

    def free(self, owner: str) -> None:
        """Drop an owner from every tier (device pages, host entry,
        spill registration, prefetch stamp)."""
        self.pool.free(owner)
        self.host.pop(owner)
        self._spillables.pop(owner, None)
        self._prefetched.pop(owner, None)
        self._last_used.pop(owner, None)
        self._pinned.discard(owner)

    def free_transient(self, prefixes: Optional[Sequence[str]] = None) -> None:
        self.pool.free_transient(prefixes)

    # ----------------------------------------------------------- pressure
    def _candidates(self) -> List[EvictionCandidate]:
        """Evictable owners: persistent, spill-registered, not pinned,
        and not touched in the current round (protects the live working
        set and just-prefetched owners)."""
        cands = []
        for owner, a in self.pool._allocs.items():
            if not a.persistent:
                continue
            info = parse_owner(owner)
            if info.transient:
                continue
            if owner in self._pinned or owner not in self._spillables:
                continue
            if self._last_used.get(owner, -1) >= self.round_idx:
                continue
            cands.append(EvictionCandidate(owner, info, a.n_pages,
                                           self._last_used.get(owner, -1)))
        return cands

    def _make_room(self, n_pages: int) -> None:
        """Spill cold owners (policy order) until ``n_pages`` fit, or
        re-raise :class:`PoolExhausted` if even full eviction falls short."""
        for c in self.eviction.order(self._candidates()):
            if self.pool.free_pages >= n_pages:
                break
            self.spill(c.owner)
        if self.pool.free_pages < n_pages:
            raise PoolExhausted(
                f"need {n_pages} pages, free {self.pool.free_pages}/"
                f"{self.pool.n_pages} even after eviction "
                f"(pinned={len(self._pinned)}, host={len(self.host)})")

    def spill(self, owner: str) -> bool:
        """Move one owner's arrays to host and free its device pages.
        Returns False (owner stays resident) if the host tier is full
        or the owner has no registered :class:`Spillable`."""
        a = self.pool._allocs.get(owner)
        sp = self._spillables.get(owner)
        if a is None or sp is None:
            return False
        arrays = [x.cpu() for x in sp.get()]
        nbytes = sum(x.numel() * x.element_size() for x in arrays)
        if not self.host.fits(nbytes):
            return False
        sp.put(arrays)
        self.host.put(HostEntry(owner, a.n_pages, nbytes, a.persistent,
                                self.round_idx))
        self.pool.free(owner)
        self.pool.swap_events += 1
        self.ledger.bump(self.scope, spill_events=1, spilled_bytes=nbytes,
                         spilled_pages=a.n_pages)
        self._prefetched.pop(owner, None)
        return True

    def reload(self, owner: str, *, prefetched: bool = False) -> None:
        """Bring a spilled owner back: device pages re-claimed (possibly
        evicting someone else) and tensors moved to ``device`` in place.
        On :class:`PoolExhausted` the host entry is untouched, so a
        failed (best-effort) reload can simply be retried later."""
        entry = self.host.get(owner)
        assert entry is not None, f"{owner} is not spilled"
        try:
            self.pool.alloc(owner, entry.n_pages, persistent=entry.persistent)
        except PoolExhausted:
            self._make_room(entry.n_pages)
            self.pool.alloc(owner, entry.n_pages, persistent=entry.persistent)
        self.host.pop(owner)
        sp = self._spillables[owner]
        sp.put([x.to(self.device) for x in sp.get()])
        self.pool.swap_events += 1
        self.ledger.bump(self.scope, reload_events=1,
                         reloaded_bytes=entry.nbytes,
                         reloaded_pages=entry.n_pages)
        if prefetched:
            self.ledger.bump(self.scope, prefetched_reloads=1)
            self._prefetched[owner] = self.round_idx
        else:
            self.ledger.bump(self.scope, sync_reloads=1)
        self.touch(owner)

    # ------------------------------------------------------------ consume
    def ensure_resident(self, owner: str) -> None:
        """Consumer-side residency check: reload synchronously if the
        owner is cold, count a hit if a prefetch already warmed it, and
        stamp the owner as used this round either way."""
        if owner in self.host:
            self.reload(owner)
        elif owner in self._prefetched:
            self._prefetched.pop(owner)
            self.ledger.bump(self.scope, prefetch_hits=1)
        if owner in self.pool._allocs:
            self.touch(owner)

    def prefetch(self, owners: Sequence[str]) -> List[str]:
        """Reload any of ``owners`` that are spilled, ahead of use.

        Best-effort: while the current round's transient working set is
        live there may be no room yet — such owners are left on host and
        returned, so the engine can retry once the round's transients
        are freed (a failed prefetch degrades to a later sync reload,
        never to an error)."""
        pending = []
        for owner in owners:
            if owner not in self.host:
                continue
            try:
                self.reload(owner, prefetched=True)
            except PoolExhausted:
                pending.append(owner)
        return pending

    def touch(self, owner: str) -> None:
        self._last_used[owner] = self.round_idx

    def pin(self, owner: str) -> None:
        self._pinned.add(owner)

    def unpin(self, owner: str) -> None:
        self._pinned.discard(owner)

    # ------------------------------------------------------------- rounds
    def begin_round(self, round_idx: int) -> None:
        self.round_idx = round_idx
        # a prefetch that nobody consumed within prefetch_ttl rounds of
        # issue is stale (ttl=1: one-round lookahead)
        for owner, stamp in list(self._prefetched.items()):
            if stamp < round_idx - self.prefetch_ttl:
                del self._prefetched[owner]

    # --------------------------------------------------------- invariants
    def check(self) -> None:
        """Assert the cross-tier invariants (used by the property tests):
        page conservation, no page owned twice, no owner in two tiers."""
        pool = self.pool
        assert pool.used_pages() + pool.free_pages == pool.n_pages, \
            "page conservation violated"
        seen = set(pool._free)
        assert len(seen) == len(pool._free), "duplicate page in free list"
        for a in pool._allocs.values():
            for p in a.pages:
                p = int(p)
                assert p not in seen, f"page {p} owned twice"
                seen.add(p)
        assert len(seen) == pool.n_pages, "pages lost"
        for owner in self.host.owners():
            assert owner not in pool._allocs, \
                f"{owner} resident in both tiers"
        self.ledger.check_scopes()
