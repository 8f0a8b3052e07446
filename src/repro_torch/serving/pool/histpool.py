"""Cross-round persistent restore pool (incremental history restore), in
PyTorch.

One :class:`HistoryPagePool` per Master family holds the family's
restored history pages ACROSS round boundaries: on round r the policy
reuses round r-1's pages for the history prefix and writes only the
round delta (the newly appended span plus the few blocks the round's
recovery recomputed), so restore work is O(round delta) instead of
O(full history). The pool owns

* the page tensors (``pool_k``/``pool_v``, [L, P, bt, KV, hd]) — the
  layout ``fused_restore_family_shared`` produces, so restored entries
  and the collector's paged path consume them unchanged;
* one page table per family member (int32 [nb]) — members alias the
  Master's pages for clean blocks, and the tables extend as histories
  grow;
* per-page reference counts + a free list, so copy-on-write block
  updates recycle pages instead of growing the tensors.

The pool registers with the tiered :class:`PoolManager` under the
persistent owner ``hist:family:<fam>`` (kind ``histpool``), spills to
host and reloads bit-exact through its :class:`Spillable`, and consumers
must ``ensure_resident`` before touching the tensors.

Writes are IN PLACE (``index_copy_``), where the JAX pool rebinds a
fresh array per write. That is safe because a write only ever targets
pages claimed from the free list by the same delta application: pages
no current page table references. The only objects that can still name
such a page are the :class:`PagedSegmentCacheEntry` objects of an
earlier round, and none of those is reachable when the next restore
writes — ``store`` clears every restored member's ``hist_entry`` at the
end of the round that built it, and nothing else keeps one
(``tests/test_torch_histpool_engines.py`` pins this with weak references).
:meth:`_grow` and :meth:`promote` replace the tensors; entries built
after either read the new ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.serving.pool.manager import Spillable
from repro_torch.serving.pool.owners import hist_pool_owner


@dataclass
class PendingDelta:
    """The round delta recorded at store(r), applied at the next restore.

    ``dirty`` maps each family member to the history blocks (< ``h_prev``)
    its round-r recovery recomputed (the reuse plan's per-agent selected
    positions, block-granular) — the only prefix blocks whose pool pages
    are stale. The appended span ``[h_prev, h_new)`` is restored from the
    round-r family via ``trim_family(..., start=h_prev)``.
    """

    h_prev: int                       # pool span before the delta
    h_new: int                        # history span after round r
    dirty: Dict[str, np.ndarray]      # member -> int32 [n] block ids
    round_idx: int                    # the round whose store recorded it


def _content(x: torch.Tensor) -> np.ndarray:
    """The raw bytes of a block, on the host (any dtype)."""
    return x.detach().contiguous().view(torch.uint8).cpu().numpy()


class COWDedup:
    """Content-addressed page sharing for one copy-on-write batch.

    When several family members dirty the SAME history block and the
    rewritten contents are bit-identical (neither mirror's diff covers
    the block, so both rewrite the Master's bytes), the batch allocates
    ONE page and points every member's table at it (refcount > 1).

    Keys are ``(block id, K bytes, V bytes)``; a digest-first index keeps
    lookups cheap and every hit is verified against the stored bytes, so
    a hash collision can never alias two different contents.
    """

    def __init__(self) -> None:
        self._index: Dict[tuple, list] = {}
        self.hits = 0

    @staticmethod
    def _digest(block: int, kb: np.ndarray, vb: np.ndarray) -> tuple:
        return (int(block), hash(kb.tobytes()), hash(vb.tobytes()))

    def match(self, block: int, kb, vb) -> Optional[int]:
        """Page already holding exactly this content for ``block``, if
        any (counts a hit), else None."""
        kb, vb = _content(kb), _content(vb)
        for page, k0, v0 in self._index.get(self._digest(block, kb, vb), []):
            if np.array_equal(k0, kb) and np.array_equal(v0, vb):
                self.hits += 1
                return page
        return None

    def insert(self, block: int, kb, vb, page: int) -> None:
        kb, vb = _content(kb), _content(vb)
        self._index.setdefault(self._digest(block, kb, vb), []) \
            .append((int(page), kb, vb))


class HistoryPagePool:
    """Persistent page pool for one Master family's restored histories."""

    def __init__(self, group_key: tuple, pool_k: torch.Tensor,
                 pool_v: torch.Tensor, page_tables: Dict[str, np.ndarray],
                 span_len: int, block_tokens: int, round_idx: int) -> None:
        self.group_key = tuple(group_key)
        self.pool_k = pool_k
        self.pool_v = pool_v
        self.page_tables = {a: np.asarray(t, np.int32).copy()
                            for a, t in page_tables.items()}
        self.span_len = int(span_len)
        self.block_tokens = int(block_tokens)
        self.round_idx = int(round_idx)
        self.pending: Optional[PendingDelta] = None
        #: pages added by capacity growth since creation (ledger honesty)
        self.grown_pages = 0
        cap = int(pool_k.shape[1])
        ref = np.zeros(cap, np.int64)
        for t in self.page_tables.values():
            np.add.at(ref, t, 1)
        self.refcount = ref
        # pages the creating restore wrote but nothing references (the
        # family pack's padded diff rows) are immediately reusable
        self.free_list = [p for p in range(cap) if ref[p] == 0]

    # ------------------------------------------------------------ props
    @property
    def owner(self) -> str:
        return hist_pool_owner(self.group_key)

    @property
    def capacity(self) -> int:
        return int(self.pool_k.shape[1])

    # ------------------------------------------------------ page allocs
    def alloc_pages(self, n: int) -> np.ndarray:
        """Claim ``n`` pages (refcount 0 until a table references them),
        growing the tensors geometrically when the free list runs dry."""
        if n > len(self.free_list):
            need = n - len(self.free_list)
            self._grow(max(need, self.capacity // 2))
        pages = [self.free_list.pop() for _ in range(n)]
        return np.asarray(pages, np.int32)

    def _grow(self, add: int) -> None:
        """Append ``add`` zeroed pages: NEW tensors (entries built before
        keep the old ones, which no write touches again)."""
        L, _, bt, KV, hd = self.pool_k.shape
        cap = self.capacity
        pad = (L, add, bt, KV, hd)
        self.pool_k = torch.cat([self.pool_k, self.pool_k.new_zeros(pad)],
                                dim=1)
        self.pool_v = torch.cat([self.pool_v, self.pool_v.new_zeros(pad)],
                                dim=1)
        self.refcount = np.concatenate(
            [self.refcount, np.zeros(add, np.int64)])
        self.free_list.extend(range(cap, cap + add))
        self.grown_pages += add

    def promote(self, dtype: torch.dtype) -> None:
        """Widen the page tensors to hold ``dtype`` exactly (new tensors,
        like a growth). A bf16 model's round-0 family is bf16 while
        recovery produces f32 families from round 1 on, so its pool meets
        f32 deltas; widening keeps every earlier page's value (bf16 ->
        f32 is exact) where casting the delta down would not."""
        dt = torch.promote_types(self.pool_k.dtype, dtype)
        if dt != self.pool_k.dtype:
            self.pool_k = self.pool_k.to(dt)
            self.pool_v = self.pool_v.to(dt)

    def incref(self, pages) -> None:
        np.add.at(self.refcount, np.asarray(pages, np.int64), 1)

    def decref(self, pages) -> None:
        """Drop references; pages reaching zero return to the free list."""
        for p in np.asarray(pages).ravel():
            p = int(p)
            self.refcount[p] -= 1
            assert self.refcount[p] >= 0, (p, "refcount underflow")
            if self.refcount[p] == 0:
                self.free_list.append(p)

    def release_unreferenced(self, pages) -> int:
        """Return any of ``pages`` nothing ended up referencing (padded
        diff rows of a family launch) to the free list."""
        freed = 0
        for p in np.asarray(pages).ravel():
            p = int(p)
            if self.refcount[p] == 0 and p not in self.free_list:
                self.free_list.append(p)
                freed += 1
        return freed

    # ---------------------------------------------------------- writes
    def write_pages(self, pages, kb: torch.Tensor, vb: torch.Tensor) -> None:
        """Write block contents ([L, n, bt, KV, hd]) into ``pages``, in
        place. ``pages`` must be pages the caller claimed from the free
        list for this delta (see the module docstring); the map is
        checked against the capacity on the host first, since a CUDA
        scatter would write outside the tensors."""
        pages = np.asarray(pages, np.int32)
        assert pages.size == 0 or (pages.min() >= 0
                                   and pages.max() < self.capacity), \
            (self.owner, "write outside the pool")
        idx = torch.as_tensor(pages, dtype=torch.long,
                              device=self.pool_k.device)
        self.pool_k.index_copy_(1, idx, kb)
        self.pool_v.index_copy_(1, idx, vb)

    # ----------------------------------------------------------- tiers
    def spillable(self) -> Spillable:
        """Move the page tensors host<->device in place; tables, refcounts
        and the free list are host state and stay put."""
        def get():
            return (self.pool_k, self.pool_v)

        def put(arrs):
            self.pool_k, self.pool_v = arrs
        return Spillable(get, put)

    # ------------------------------------------------------ invariants
    def check(self) -> None:
        """Internal invariants: tables only reference live pages,
        refcounts match table references, and the free list is exactly
        the unreferenced pages."""
        cap = self.capacity
        ref = np.zeros(cap, np.int64)
        for t in self.page_tables.values():
            assert t.min(initial=0) >= 0 and t.max(initial=-1) < cap, \
                (self.owner, "page table out of range")
            np.add.at(ref, t, 1)
        assert np.array_equal(ref, self.refcount), \
            (self.owner, "refcount drift")
        free = sorted(self.free_list)
        assert free == sorted(set(free)), (self.owner, "free list dup")
        assert free == [p for p in range(cap) if ref[p] == 0], \
            (self.owner, "free list != unreferenced pages")
