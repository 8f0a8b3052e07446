"""Page-sharing family restore (paper §4.4) in PyTorch.

:func:`fused_restore_family_shared` rebuilds a Master family into a page
pool for aligned frames (the in-family case the serving engine hits every
round): the Master's blocks are written once and each mirror's DIFF
blocks to private pages, so per-family work is ``nb + M*ndb`` pages
instead of ``M*nb``; a mirror's clean blocks alias the Master's pages
through its page table. In aligned frames the write needs no rotation, so
it is pure data movement (``index_copy_``), as the JAX engine's
``_shared_scatter`` is.

Writes are in place, and only ever into a pool this module has just
allocated (:func:`_shared_build`) and has not handed to any reader yet:
once returned, a pool is only read (``PagedSegmentCacheEntry`` references
it for the round), so no reader can see a later write.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.diff_store import _pad_to_blocks, pack_family


def gather_pages(pool_k: torch.Tensor, pool_v: torch.Tensor, page_idx,
                 seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize one paged entry: gather ``page_idx`` ([nbh] int32) out
    of the pools ([L, P, bt, KV, hd]) into dense (k, v) ``[L, seq_len,
    KV, hd]`` — THE page->dense layout every densifying consumer uses."""
    L, _, bt, KV, hd = pool_k.shape
    pages = torch.as_tensor(np.asarray(page_idx), dtype=torch.long,
                            device=pool_k.device)
    nbh = int(pages.shape[0])
    k = pool_k[:, pages].reshape(L, nbh * bt, KV, hd)[:, :seq_len]
    v = pool_v[:, pages].reshape(L, nbh * bt, KV, hd)[:, :seq_len]
    return k, v


def _shared_scatter(master_kb, master_vb, diff_k, diff_v, master_map,
                    diff_map, pool_k, pool_v):
    """The sharing-mode page write, in place into ``pool_k``/``pool_v``:
    the Master's blocks once + every mirror's diff rows. [L, nb, ...]
    master, [M, L, ndb, ...] diffs, maps long [nb] / [M, ndb] (disjoint
    pages)."""
    L = master_kb.shape[0]
    pool_k.index_copy_(1, master_map, master_kb)
    pool_v.index_copy_(1, master_map, master_vb)
    M, _, ndb = diff_k.shape[:3]
    if ndb:
        rows = diff_map.reshape(-1)
        pool_k.index_copy_(1, rows, diff_k.movedim(0, 1).reshape(
            (L, M * ndb) + tuple(diff_k.shape[3:])))
        pool_v.index_copy_(1, rows, diff_v.movedim(0, 1).reshape(
            (L, M * ndb) + tuple(diff_v.shape[3:])))
    return pool_k, pool_v


def _shared_build(master_kb, master_vb, diff_k, diff_v, master_map, diff_map,
                  *, n_pages: int):
    """:func:`_shared_scatter` into a fresh zeroed pool of ``n_pages``."""
    shape = (master_kb.shape[0], n_pages) + tuple(master_kb.shape[2:])
    pool_k = torch.zeros(shape, dtype=master_kb.dtype,
                         device=master_kb.device)
    pool_v = torch.zeros_like(pool_k)
    return _shared_scatter(master_kb, master_vb, diff_k, diff_v, master_map,
                           diff_map, pool_k, pool_v)


def family_pool_pages(handles) -> int:
    """Pool pages the page-sharing restore needs with default maps:
    ``nb`` Master pages + ``M * ndb`` diff pages (ndb = family max diff
    count, min 1 — pack_family's padding rule)."""
    nb = -(-handles[0].diff.seq_len // handles[0].diff.block_tokens)
    ndb = max(1, max(h.diff.n_blocks for h in handles))
    return nb + len(handles) * ndb


def fused_restore_family_shared(handles, *, master_map=None, diff_maps=None,
                                n_pages: Optional[int] = None):
    """Page-sharing family restore for aligned frames (in-family mirrors)
    into a fresh pool. Returns ``(pool_k, pool_v, page_idx)``;
    ``page_idx`` int32 [M, nb] maps each mirror's logical block to its
    pool page, so gathering ``pool[:, page_idx[m]]`` gives mirror m.

    ``master_map`` int32 [nb] and ``diff_maps`` int32 [M, ndb] are the
    destination pages, disjoint (defaults: ``[0, nb)`` for the Master,
    ``[nb, nb + M*ndb)`` for the diffs). ``n_pages`` sizes the pool (the
    pool manager's grant); it must cover every mapped page. The check is
    explicit: an out-of-range page must fail here, whatever a scatter
    would do with it.
    """
    assert handles, "empty family"
    for h in handles:
        assert np.array_equal(h.diff.old_pos, h.diff.new_pos), \
            "page-sharing restore requires aligned frames"
    pack = pack_family(handles)
    master = handles[0].master
    bt, nb = pack.block_tokens, pack.nb
    M, ndb = pack.diff_slot.shape[0], pack.diff_k.shape[2]
    mk = _pad_to_blocks(master.k, bt)
    mv = _pad_to_blocks(master.v, bt)
    L, Sp, KV, hd = mk.shape
    if master_map is None:
        master_map = np.arange(nb, dtype=np.int32)
    if diff_maps is None:
        diff_maps = (nb + np.arange(M * ndb, dtype=np.int32)).reshape(M, ndb)
    master_map = np.asarray(master_map, np.int32)
    diff_maps = np.asarray(diff_maps, np.int32)
    n_addr = int(max(master_map.max(), diff_maps.max())) + 1
    if n_pages is not None:
        assert n_pages >= n_addr, \
            (n_pages, n_addr, "n_pages smaller than the page maps "
             "address — size the grant with family_pool_pages()")
    dev = mk.device

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    pool_k, pool_v = _shared_build(
        mk.reshape(L, nb, bt, KV, hd), mv.reshape(L, nb, bt, KV, hd),
        pack.diff_k, pack.diff_v, idx(master_map), idx(diff_maps),
        n_pages=n_addr if n_pages is None else int(n_pages))
    slot = pack.diff_slot                                    # [M, nb]
    page_idx = np.where(
        slot >= 0,
        np.take_along_axis(diff_maps, np.maximum(slot, 0), axis=1),
        master_map[None, :]).astype(np.int32)
    return pool_k, pool_v, page_idx
