"""Mirror restore paths (paper §4.4, Algorithm 1) in PyTorch.

Three implementations with identical results, increasing in how much
work they amortize:

* :func:`dense_restore` / :func:`dense_restore_paged` — the naive
  baseline: a dense copy of the Master, the diff blocks written over it,
  RoPE recovery, then a separate scatter into the pool (torch ops).
* :func:`fused_restore_paged` — per mirror: diff select, RoPE recovery
  and the page write in ONE ``fused_diff_restore`` launch. A family of
  M mirrors pays M launches and reads every Master block M times.
* :func:`fused_restore_family_paged` — the whole family in ONE
  ``fused_family_restore`` launch: each Master block is read once and
  written for all M mirrors.

:func:`fused_restore_family_shared` is the page-sharing mode for aligned
frames (the in-family case the serving engine hits every round): the
Master's blocks are written once and each mirror's DIFF blocks to
private pages, so per-family work is ``nb + M*ndb`` pages instead of
``M*nb``; a mirror's clean blocks alias the Master's pages through its
page table. In aligned frames the write needs no rotation, so it is
pure data movement (``index_copy_``), as the JAX engine's
``_shared_scatter`` is.

The paged paths write IN PLACE into the pools they are given (the
caller owns them; the JAX paths return updated copies). The page-sharing
mode writes into a pool it has just allocated (:func:`_shared_build`),
or, for the cross-round restore pool's delta, into pages of a provided
pool that no live reader names (``serving/pool/histpool.py`` says why
that holds).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.diff_store import (MirrorHandle, _pad_to_blocks,
                                         pack_family)
from repro_torch.kernels import ops
from repro_torch.models.layers import rope_shift


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


def _delta_pos(diff) -> Optional[torch.Tensor]:
    """int32 ``new_pos - old_pos`` [S] on the diff's device, or None for
    aligned frames (no rotation at all)."""
    old = np.asarray(diff.old_pos)
    new = np.asarray(diff.new_pos)
    if np.array_equal(old, new):
        return None
    return torch.as_tensor((new - old).astype(np.int32),
                           device=diff.k_vals.device)


def _master_blocks(handle: MirrorHandle, bt: int):
    """The Master's K/V as contiguous blocks ``[L, nb, bt, KV, hd]``
    (the token axis zero-padded to a block multiple)."""
    mk = _pad_to_blocks(handle.master.k, bt)
    mv = _pad_to_blocks(handle.master.v, bt)
    L, Sp, KV, hd = mk.shape
    shape = (L, Sp // bt, bt, KV, hd)
    return mk.reshape(shape).contiguous(), mv.reshape(shape).contiguous()


def dense_restore(handle: MirrorHandle,
                  theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive path: dense Master copy -> overwrite diff blocks -> RoPE.
    Returns (k, v) ``[L, S, KV, hd]``, new tensors."""
    diff = handle.diff
    bt = diff.block_tokens
    kb, vb = _master_blocks(handle, bt)
    kb, vb = kb.clone(), vb.clone()   # the write-then-read Alg. 1 avoids
    L, nb, _, KV, hd = kb.shape
    idx = torch.as_tensor(diff.block_idx, dtype=torch.long, device=kb.device)
    kb[:, idx] = diff.k_vals
    vb[:, idx] = diff.v_vals
    k = kb.reshape(L, nb * bt, KV, hd)[:, : diff.seq_len]
    v = vb.reshape(L, nb * bt, KV, hd)[:, : diff.seq_len]
    dp = _delta_pos(diff)
    if dp is not None:
        k = rope_shift(k, torch.zeros_like(dp), dp, theta)
    return k, v


def dense_restore_paged(handle: MirrorHandle, theta: float, slot_map,
                        pool_k: torch.Tensor, pool_v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dense_restore` followed by a separate scatter into the
    pools' pages ``slot_map`` ([nb] ints), in place — the two-step
    baseline of Fig. 13."""
    bt = handle.diff.block_tokens
    k, v = dense_restore(handle, theta)
    kp, vp = _pad_to_blocks(k, bt), _pad_to_blocks(v, bt)
    L, Sp, KV, hd = kp.shape
    pages = torch.as_tensor(np.asarray(slot_map), dtype=torch.long,
                            device=pool_k.device)
    pool_k[:, pages] = kp.reshape(L, Sp // bt, bt, KV, hd)
    pool_v[:, pages] = vp.reshape(L, Sp // bt, bt, KV, hd)
    return pool_k, pool_v


def dense_restore_batch(handles, theta: float):
    """Restore ALL of a round family's mirrors in one batched write:
    ``(k, v)`` ``[M, L, S, KV, hd]``. Requires aligned frames (in-family
    mirrors share positions)."""
    assert handles, "empty family"
    bt = handles[0].diff.block_tokens
    kb, vb = _master_blocks(handles[0], bt)
    L, nb, _, KV, hd = kb.shape
    M = len(handles)
    k_all = kb[None].repeat(M, 1, 1, 1, 1, 1)
    v_all = vb[None].repeat(M, 1, 1, 1, 1, 1)
    for m, h in enumerate(handles):
        d = h.diff
        assert np.array_equal(d.old_pos, d.new_pos), \
            "batched restore requires aligned frames"
        idx = torch.as_tensor(d.block_idx, dtype=torch.long, device=kb.device)
        k_all[m][:, idx] = d.k_vals
        v_all[m][:, idx] = d.v_vals
    S = handles[0].diff.seq_len
    return (k_all.reshape(M, L, nb * bt, KV, hd)[:, :, :S],
            v_all.reshape(M, L, nb * bt, KV, hd)[:, :, :S])


def fused_restore_paged(handle: MirrorHandle, theta: float, slot_map,
                        pool_k: torch.Tensor, pool_v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 for one mirror: the block-sparse diff and the RoPE
    recovery applied in the pass that writes the pool pages ``slot_map``
    ([nb] ints) — ONE ``fused_diff_restore`` launch, in place. No dense
    Mirror is ever built."""
    diff = handle.diff
    bt = diff.block_tokens
    kb, vb = _master_blocks(handle, bt)
    nb = kb.shape[1]
    diff_slot = np.full((nb,), -1, np.int32)
    diff_slot[np.asarray(diff.block_idx)] = np.arange(diff.n_blocks)
    dp = np.zeros((nb * bt,), np.int32)
    dp[: diff.seq_len] = (np.asarray(diff.new_pos, np.int64)
                          - np.asarray(diff.old_pos, np.int64))
    return ops.fused_diff_restore(
        kb, vb, diff.k_vals.contiguous(), diff.v_vals.contiguous(),
        diff_slot, np.asarray(slot_map), dp.reshape(nb, bt), theta, pool_k,
        pool_v)


def fused_restore_family_paged(handles, theta: float, slot_maps,
                               pool_k: torch.Tensor, pool_v: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Family-batched Algorithm 1: EVERY mirror of one Master family in
    ONE ``fused_family_restore`` launch, in place. ``handles`` share one
    Master; ``slot_maps`` is int [M, nb] with disjoint pages. The same
    pages as :func:`fused_restore_paged` once per handle, but each
    Master block is read once instead of M times."""
    assert handles, "empty family"
    pack = pack_family(handles)
    kb, vb = _master_blocks(handles[0], pack.block_tokens)
    return ops.fused_family_restore(
        kb, vb, pack.diff_k, pack.diff_v, pack.diff_slot,
        np.asarray(slot_maps), pack.delta_pos, theta, pool_k, pool_v)


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


def fused_restore_family_shared(handles, pool_k: Optional[torch.Tensor] = None,
                                pool_v: Optional[torch.Tensor] = None, *,
                                master_map=None, diff_maps=None,
                                n_pages: Optional[int] = None):
    """Page-sharing family restore for aligned frames (in-family mirrors).
    Returns ``(pool_k, pool_v, page_idx)``; ``page_idx`` int32 [M, nb]
    maps each mirror's logical block to its pool page, so gathering
    ``pool[:, page_idx[m]]`` gives mirror m.

    ``master_map`` int32 [nb] and ``diff_maps`` int32 [M, ndb] are the
    destination pages, disjoint (defaults: ``[0, nb)`` for the Master,
    ``[nb, nb + M*ndb)`` for the diffs).

    Omit ``pool_k``/``pool_v`` to get a fresh zeroed pool; ``n_pages``
    sizes it (the pool manager's grant) and must cover every mapped page.
    Given pools are written IN PLACE (the cross-round restore pool's
    delta launch) and must be large enough for the maps. Both checks run
    on the host before the write: an out-of-range page must fail here,
    since a CUDA scatter would write outside the pool.
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
    assert int(min(master_map.min(), diff_maps.min())) >= 0, \
        "negative page in the maps"
    dev = mk.device

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    args = (mk.reshape(L, nb, bt, KV, hd), mv.reshape(L, nb, bt, KV, hd),
            pack.diff_k, pack.diff_v, idx(master_map), idx(diff_maps))
    if pool_k is None:
        if n_pages is not None:
            assert n_pages >= n_addr, \
                (n_pages, n_addr, "n_pages smaller than the page maps "
                 "address — size the grant with family_pool_pages()")
        pool_k, pool_v = _shared_build(
            *args, n_pages=n_addr if n_pages is None else int(n_pages))
    else:
        assert pool_k.shape[1] >= n_addr and pool_v.shape[1] >= n_addr, \
            (tuple(pool_k.shape), tuple(pool_v.shape),
             "pool smaller than the page maps address — "
             "size it with family_pool_pages()")
        pool_k, pool_v = _shared_scatter(*args, pool_k, pool_v)
    slot = pack.diff_slot                                    # [M, nb]
    page_idx = np.where(
        slot >= 0,
        np.take_along_axis(diff_maps, np.maximum(slot, 0), axis=1),
        master_map[None, :]).astype(np.int32)
    return pool_k, pool_v, page_idx
