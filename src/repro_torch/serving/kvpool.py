"""Paged KV cache pool: block-granular allocation + byte accounting.

The pool is the capacity ledger of the serving engine: which owner holds
how many KV pages, peak usage, and the persistent-vs-transient split (the
quantities behind the paper's Figs. 2 and 10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class PoolExhausted(Exception):
    """Raised when an allocation cannot be satisfied; the engine treats it
    as a preemption/swap event (latency penalty)."""


@dataclass
class Allocation:
    owner: str
    pages: np.ndarray        # int32 page ids
    persistent: bool         # survives the round (agent state) or not
    #: set once the pages went back to the free list; a stale Allocation
    #: object can then never return them a second time (double-free guard)
    released: bool = False

    @property
    def n_pages(self) -> int:
        return int(self.pages.shape[0])


class PagedKVPool:
    """Block-granular KV page allocator + byte ledger.

    One page holds ``block_tokens`` tokens of K AND V across all layers
    (``page_bytes`` = 2 * L * bt * KV * hd * itemsize). Owners are string
    keys; an owner's allocation is replaced wholesale (``free`` then
    ``alloc``). The serving policies use well-known owner keys:
    ``round:<aid>`` (transient per-round working set), ``sess:<aid>`` /
    ``hist:<aid>`` / ``out:<aid>`` (persistent agent state),
    ``td:master:<gid>`` / ``td:mirrors:<gid>`` (Diff-Aware Storage at
    rest, one entry per gather group) and ``restore:family:<gid>`` (the
    page-sharing restore pool, accounted ONCE per Master family — the
    ledger face of §4.4: mirrors alias the Master's pages instead of
    each allocating their own copy).

    The pool is the ledger only: the physical pages of each working set
    are tensors owned by the code that fills them (restore pools, the
    decode state). ``dtype`` sizes the ledger's pages.
    """

    def __init__(self, cfg: ModelConfig, n_pages: int,
                 block_tokens: int = 32, dtype=torch.float32):
        self.cfg = cfg
        self.n_pages = n_pages
        self.bt = block_tokens
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self._free: List[int] = list(range(n_pages))
        self._allocs: Dict[str, Allocation] = {}
        self.peak_pages = 0
        self.swap_events = 0

    # ------------------------------------------------------------- sizing
    def page_bytes(self) -> int:
        KV, hd = self.cfg.n_kv_heads, self.cfg.resolved_head_dim
        return 2 * self.cfg.n_layers * self.bt * KV * hd * self.itemsize

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.bt)

    # --------------------------------------------------------------- api
    def alloc(self, owner: str, n_pages: int, *, persistent: bool) -> Allocation:
        """Claim ``n_pages`` free pages for ``owner``.

        ``persistent=True`` marks state that survives the round (agent
        histories, Diff-Aware Storage); ``False`` marks round-transient
        working sets that :meth:`free_transient` reclaims in bulk.
        Raises :class:`PoolExhausted` when the pool cannot satisfy the
        request — the engine treats that as a preemption/swap event —
        and :class:`ValueError` when ``owner`` is still live: silently
        replacing a live allocation would leak its pages, so callers
        must :meth:`free` first.
        """
        if owner in self._allocs:
            raise ValueError(
                f"owner {owner!r} is still allocated "
                f"({self._allocs[owner].n_pages} pages); free() it first — "
                f"re-allocating a live owner would leak its pages")
        if len(self._free) < n_pages:
            raise PoolExhausted(
                f"{owner}: need {n_pages}, free {len(self._free)}/{self.n_pages}")
        pages = np.asarray([self._free.pop() for _ in range(n_pages)], np.int32)
        a = Allocation(owner, pages, persistent)
        self._allocs[owner] = a
        self.peak_pages = max(self.peak_pages, self.used_pages())
        return a

    def alloc_tokens(self, owner: str, n_tokens: int, *, persistent: bool) -> Allocation:
        """:meth:`alloc` sized in tokens: claims ``ceil(n_tokens / bt)``
        pages (a partial trailing block still occupies a whole page)."""
        return self.alloc(owner, self.pages_for_tokens(n_tokens),
                          persistent=persistent)

    def append_page(self, owner: str) -> int:
        """Claim ONE more free page for an existing allocation and return
        its id — the decode loop's grow path: ``round:<aid>`` starts at
        the prompt's pages and claims a fresh page each time generation
        crosses a block boundary (the page then fills slot by slot across
        steps and is sealed when the next append happens). Raises
        :class:`KeyError` for an unknown owner and :class:`PoolExhausted`
        when the free list is dry — the manager layers eviction on top.
        """
        a = self._allocs.get(owner)
        if a is None:
            raise KeyError(
                f"append_page: owner {owner!r} has no live allocation")
        if not self._free:
            raise PoolExhausted(
                f"{owner}: need 1 more page, free 0/{self.n_pages}")
        page = self._free.pop()
        a.pages = np.append(a.pages, np.int32(page))
        self.peak_pages = max(self.peak_pages, self.used_pages())
        return page

    def free(self, owner: str) -> None:
        """Return ``owner``'s pages to the free list (no-op if absent)."""
        a = self._allocs.pop(owner, None)
        if a is not None:
            self._release(a)

    def _release(self, a: Allocation) -> None:
        """Return an allocation's pages exactly once. A stale
        :class:`Allocation` (already released, e.g. kept across a
        free+alloc of the same owner) raises instead of corrupting the
        free list with duplicate page ids."""
        if a.released:
            raise ValueError(
                f"double free of {a.owner!r}: its pages were already "
                f"returned to the free list")
        a.released = True
        self._free.extend(int(p) for p in a.pages)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def free_transient(self, prefixes: Optional[Sequence[str]] = None) -> None:
        """Reclaim non-persistent allocations — the engine calls this at
        round boundaries so only agent state carries over. ``prefixes``
        restricts the sweep to owners matching any of the given key
        prefixes: the continuous engine frees ONE committee's transients
        (``restore:family:g<c>``, ``round:<aid>``) while another
        committee's round working set is still in flight."""
        for owner in [o for o, a in self._allocs.items() if not a.persistent
                      and (prefixes is None
                           or any(o.startswith(p) for p in prefixes))]:
            self.free(owner)

    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def used_bytes(self) -> int:
        return self.used_pages() * self.page_bytes()

    def peak_bytes(self) -> int:
        return self.peak_pages * self.page_bytes()

    def utilization(self) -> float:
        return self.used_pages() / self.n_pages

    def owners(self) -> List[str]:
        return list(self._allocs)
