"""Round-KV view over the paged decode loop's cache.

The paged decode hands ``store()`` its round pool (``pk``/``pv``
``[L, P, bt, KV, hd]``) plus the per-sequence page table ``page_idx``
``[N, nbt]``. Policies extract block-aligned regions — the history span,
the output block, the prefill region — through :func:`round_kv`, whose
``slice(lo, hi)`` gathers exactly that region as dense
``[L, N, hi-lo, KV, hd]`` rows (a copy: nothing downstream holds a view
of the round pool).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class PagedRoundKV:
    """View over a paged round cache: pool [L, P, bt, KV, hd] + page
    table [N, nbt] (each agent's pages in dense order)."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    page_idx: torch.Tensor      # [N, nbt] int32

    @property
    def bt(self) -> int:
        return int(self.pool_k.shape[2])

    @property
    def total(self) -> int:
        return int(self.page_idx.shape[1]) * self.bt

    def slice(self, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather [L, N, hi-lo, KV, hd] out of the pool: page rows
        ``lo//bt .. ceil(hi/bt)``, edge-trimmed for non-aligned bounds."""
        L, P, bt, KV, hd = self.pool_k.shape
        N = self.page_idx.shape[0]
        p0, p1 = lo // bt, -(-hi // bt)
        rows = self.page_idx[:, p0:p1].long()        # [N, p1-p0]

        def gather(pool):
            x = pool[:, rows]                        # [L, N, p1-p0, bt, KV, hd]
            x = x.reshape(L, N, (p1 - p0) * bt, KV, hd)
            return x[:, :, lo - p0 * bt : hi - p0 * bt]

        return gather(self.pool_k), gather(self.pool_v)


def round_kv(cache: dict):
    """Wrap a paged decode cache in its view, or ``None`` when the cache
    carries no paged attention KV."""
    if "pk" in cache:
        return PagedRoundKV(cache["pk"], cache["pv"], cache["page_idx"])
    return None
