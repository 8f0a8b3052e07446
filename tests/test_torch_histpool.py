"""The cross-round incremental restore in the port: its unit mechanics.

The port's ``TokenDancePolicy`` defaults (``incremental=True``) keep each
family's restored pages in a ``HistoryPagePool`` across rounds and write
only the round delta. Held here: the delta trims, prefix-extension
entries, the pool's refcounts and growth, copy-on-write dedup, and a
provided pool checked before the write. The engine-level parity with the
JAX package is in ``test_torch_histpool_engines.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.diff_store import build_round_family, trim_family
from repro_torch.core.restore import dense_restore, fused_restore_family_shared
from repro_torch.core.segments import PagedSegmentCacheEntry
from repro_torch.serving import TokenDancePolicy
from repro_torch.serving.pool import (COWDedup, HistoryPagePool, PendingDelta,
                                      hist_pool_owner)

torch.set_num_threads(1)


# ------------------------------------------------------------------- unit
def _family(rng, N, nb, *, bt=16, KV=2, hd=8, L=2):
    S = nb * bt
    base = rng.normal(size=(L, S, KV, hd)).astype(np.float32)
    caches = [base]
    for _ in range(N - 1):
        x = base.copy()
        for b in rng.choice(nb, max(1, nb // 3), replace=False):
            x[:, b * bt:(b + 1) * bt] += 0.1 * rng.normal(
                size=(L, bt, KV, hd)).astype(np.float32)
        caches.append(x)
    ks = torch.from_numpy(np.stack(caches))
    master, handles = build_round_family(
        [f"r{i}" for i in range(N)], ks, -ks, np.arange(S), 0,
        block_tokens=bt)
    return master, handles, caches, bt


def test_trim_family_start_offset_is_the_suffix():
    """trim_family(h_new, start=h_prev) is the family restricted to the
    delta span, with its diff blocks re-based."""
    rng = np.random.default_rng(5)
    master, handles, caches, bt = _family(rng, 3, nb=6)
    h_prev, h_new = 2 * bt, 5 * bt
    delta = trim_family(handles, h_new, start=h_prev)
    for h, cache in zip(delta, caches[1:]):
        assert h.diff.seq_len == h_new - h_prev
        assert torch.equal(h.master.k, master.k[:, h_prev:h_new])
        nb_d = (h_new - h_prev) // bt
        assert h.diff.block_idx.min(initial=0) >= 0
        assert h.diff.block_idx.max(initial=-1) < nb_d
        dk, dv = dense_restore(h, 1e4)
        np.testing.assert_array_equal(dk.numpy(), cache[:, h_prev:h_new])
        np.testing.assert_array_equal(dv.numpy(), -cache[:, h_prev:h_new])
    full = trim_family(handles, h_new)
    for d, f in zip(delta, full):
        fb = np.asarray(f.diff.block_idx)
        keep = fb >= h_prev // bt
        np.testing.assert_array_equal(np.asarray(d.diff.block_idx),
                                      fb[keep] - h_prev // bt)
    with pytest.raises(AssertionError):
        trim_family(handles, h_new, start=bt + 1)    # not block-aligned
    with pytest.raises(AssertionError):
        trim_family(handles, h_prev, start=h_prev)   # empty span


def test_prefix_extension_entry_equals_direct_entry():
    rng = np.random.default_rng(6)
    _, handles, caches, bt = _family(rng, 3, nb=4)
    pool_k, pool_v, pages = fused_restore_family_shared(handles)
    row = np.asarray(pages[0], np.int32)
    seq_len = 4 * bt
    sp = np.arange(seq_len, dtype=np.int32)
    direct = PagedSegmentCacheEntry(
        sid="d", pool_k=pool_k, pool_v=pool_v, page_idx=row,
        src_pos=sp, seq_len=seq_len, block_tokens=bt)
    ext = PagedSegmentCacheEntry.prefix_extension(
        sid="e", pool_k=pool_k, pool_v=pool_v,
        prior_page_idx=row[:2], delta_page_idx=row[2:],
        src_pos=sp, seq_len=seq_len, block_tokens=bt)
    np.testing.assert_array_equal(ext.page_idx, direct.page_idx)
    assert torch.equal(ext.materialize().k, direct.materialize().k)
    np.testing.assert_array_equal(ext.materialize().k.numpy(),
                                  caches[1][:, :seq_len])
    with pytest.raises(AssertionError, match="tile the extended span"):
        PagedSegmentCacheEntry.prefix_extension(
            sid="bad", pool_k=pool_k, pool_v=pool_v,
            prior_page_idx=row[:2], delta_page_idx=row[2:3],
            src_pos=sp, seq_len=seq_len, block_tokens=bt)


def test_history_page_pool_mechanics():
    """Refcounts, free list, geometric growth, COW recycling and the
    self-check through an alloc/incref/decref cycle."""
    L, P, bt, KV, hd = 2, 6, 4, 2, 8
    pool_k = torch.zeros(L, P, bt, KV, hd)
    tables = {"a": np.array([0, 1], np.int32),
              "b": np.array([0, 2], np.int32)}
    hp = HistoryPagePool(("a", "b"), pool_k, torch.zeros_like(pool_k),
                         tables, span_len=2 * bt, block_tokens=bt,
                         round_idx=0)
    assert hp.owner == hist_pool_owner(("a", "b"))
    assert hp.capacity == P
    np.testing.assert_array_equal(hp.refcount, [2, 1, 1, 0, 0, 0])
    assert sorted(hp.free_list) == [3, 4, 5]
    hp.check()

    got = hp.alloc_pages(3)                      # drains the free list
    assert sorted(int(p) for p in got) == [3, 4, 5]
    before = hp.pool_k
    grown = hp.alloc_pages(2)                    # geometric growth
    assert hp.capacity > P and hp.grown_pages >= 2
    assert all(int(p) >= P for p in grown)
    assert hp.pool_k is not before and before.shape[1] == P  # new tensors

    content = torch.full((L, 1, bt, KV, hd), 7.0)
    hp.write_pages(got[:1], content, -content)
    assert torch.equal(hp.pool_k[:, int(got[0])], content[:, 0])
    assert torch.equal(hp.pool_v[:, int(got[0])], -content[:, 0])
    with pytest.raises(AssertionError, match="outside the pool"):
        hp.write_pages([hp.capacity], content, content)

    hp.page_tables["a"][0] = int(got[0])         # COW a's block 0
    hp.incref(got[:1])
    hp.decref([0])
    assert hp.refcount[0] == 1 and 0 not in hp.free_list
    hp.page_tables["b"] = hp.page_tables["b"][1:]
    hp.decref([0])
    assert 0 in hp.free_list
    hp.release_unreferenced(np.concatenate([got[1:], grown]))
    hp.check()

    with pytest.raises(AssertionError):          # underflow guard
        hp.decref([1, 1])
    hp2 = HistoryPagePool(("x",), pool_k, torch.zeros_like(pool_k),
                          {"x": np.array([0], np.int32)}, bt, bt, 0)
    hp2.refcount[0] = 5
    with pytest.raises(AssertionError, match="refcount drift"):
        hp2.check()


def test_cow_dedup_index_unit():
    """Same (block, bytes) shares a page; another block or other bytes
    never does; every hit is verified (f32 and bf16 blocks)."""
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        kb = torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(
            np.float32)).to(dtype)
        vb = torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(
            np.float32)).to(dtype)
        d = COWDedup()
        assert d.match(3, kb, vb) is None
        d.insert(3, kb, vb, 7)
        assert d.match(3, kb.clone(), vb.clone()) == 7
        assert d.hits == 1
        assert d.match(4, kb, vb) is None
        kb2 = kb.clone()
        kb2[0, 0, 0, 0] += 1.0
        assert d.match(3, kb2, vb) is None
        d.insert(3, kb2, vb, 9)
        assert d.match(3, kb2, vb) == 9
        assert d.match(3, kb, vb) == 7
        assert d.hits == 3


def test_apply_pending_cow_dedup_shares_identical_blocks():
    """Members dirtying the same block with identical contents share ONE
    freshly written page; every member's restored span stays bit-exact."""
    rng = np.random.default_rng(8)
    master, handles, caches, bt = _family(rng, 3, nb=6)
    h_prev, h_new = 4 * bt, 6 * bt
    nb_prev = h_prev // bt
    members = [f"r{i}" for i in range(3)]
    pre = trim_family(handles, h_prev)
    pool_k, pool_v, page_idx = fused_restore_family_shared(pre)
    tables = {"r0": np.arange(nb_prev, dtype=np.int32),
              "r1": np.asarray(page_idx[0], np.int32),
              "r2": np.asarray(page_idx[1], np.int32)}
    hp = HistoryPagePool(tuple(members), pool_k, pool_v, tables, h_prev, bt,
                         0)
    hp.check()
    covered = {int(x) for h in handles for x in h.diff.block_idx}
    clean = [b for b in range(nb_prev) if b not in covered]
    assert clean, "family left no clean prefix block (seed artifact)"
    b = clean[0]
    half = [b2 for b2 in range(nb_prev)
            if sum(b2 in set(map(int, h.diff.block_idx))
                   for h in handles) == 1]
    dirty = {a: np.asarray([b] + ([half[0]] if half else []), np.int32)
             for a in members}
    hp.pending = PendingDelta(h_prev=h_prev, h_new=h_new, dirty=dirty,
                              round_idx=1)
    pol = TokenDancePolicy()
    pol.rt = SimpleNamespace(
        cfg=SimpleNamespace(n_layers=2, n_kv_heads=2, resolved_head_dim=8),
        sessions={
            "r0": SimpleNamespace(is_master=True, mirror=None),
            "r1": SimpleNamespace(is_master=False, mirror=handles[0]),
            "r2": SimpleNamespace(is_master=False, mirror=handles[1]),
        })
    new_span, cow_pages, cow_hits = pol._apply_pending(
        hp, tuple(members), master)
    assert cow_pages + cow_hits == sum(t.size for t in dirty.values())
    assert cow_hits >= 2
    pages_b = {int(hp.page_tables[a][b]) for a in members}
    assert len(pages_b) == 1
    assert hp.refcount[pages_b.pop()] == 3
    if half:
        owners = {a: int(hp.page_tables[a][half[0]]) for a in members}
        deviant = members[1 + [i for i, h in enumerate(handles)
                               if half[0] in set(map(int, h.diff.block_idx))
                               ][0]]
        sharers = [a for a in members if a != deviant]
        assert owners[sharers[0]] == owners[sharers[1]]
        assert owners[deviant] != owners[sharers[0]]
    assert hp.span_len == h_new and hp.pending is None
    hp.check()
    for i, a in enumerate(members):
        for blk in range(h_new // bt):
            page = int(hp.page_tables[a][blk])
            np.testing.assert_array_equal(
                hp.pool_k[:, page].numpy(),
                caches[i][:, blk * bt:(blk + 1) * bt])
            np.testing.assert_array_equal(
                hp.pool_v[:, page].numpy(),
                -caches[i][:, blk * bt:(blk + 1) * bt])
    delta = trim_family(handles, h_new, start=h_prev)
    ndb = max(1, max(h.diff.n_blocks for h in delta))
    assert new_span == (h_new - h_prev) // bt + len(delta) * ndb


def test_provided_pool_is_checked_before_the_write():
    """A delta launch into a provided pool too small for its maps fails on
    the host, and the pool is left untouched."""
    rng = np.random.default_rng(9)
    _, handles, _, _ = _family(rng, 3, nb=4)
    pool_k, pool_v, _ = fused_restore_family_shared(handles)
    snap = pool_k.clone()
    P = pool_k.shape[1]
    with pytest.raises(AssertionError, match="pool smaller"):
        fused_restore_family_shared(
            handles, pool_k, pool_v, master_map=np.arange(4) + P - 2,
            diff_maps=np.arange(2 * 2).reshape(2, 2))
    assert torch.equal(pool_k, snap)
