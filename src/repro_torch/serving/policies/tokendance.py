"""The paper's policy in PyTorch: collective recovery (one shared pass per
gather group) + Master-Mirror diff storage + page-sharing family restore.

Inherits the cached-prompt assembly and collective recovery from
``PICPolicy``; adds Diff-Aware Storage after the round (§4.3) and the
family restore before the next one (§4.4).

The defaults are the JAX package's: restored histories stay paged
through the collector (``paged_history``, ``paged_attention``), and each
family's restored pages persist across rounds in a
:class:`~repro_torch.serving.pool.histpool.HistoryPagePool`, so round r
writes only the round delta (``incremental``). ``incremental=False``
rebuilds every family's pages each round; ``paged_history=False`` is the
dense-history oracle; ``paged_attention=False`` keeps the histories
paged up to the collector, which then densifies them (its oracle). All
four give the same outputs bit for bit.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.diff_store import (MasterCache, _pad_to_blocks,
                                         build_round_family,
                                         compression_stats, trim_family)
from repro_torch.core.restore import (family_pool_pages,
                                      fused_restore_family_shared,
                                      gather_pages)
from repro_torch.core.segments import (PagedSegmentCacheEntry,
                                       SegmentCacheEntry, segment_hash)
from repro_torch.serving.policies.base import (RecoveryResult, RoundContext,
                                               entry_spillable,
                                               register_policy)
from repro_torch.serving.policies.pic import PICPolicy
from repro_torch.serving.pool import Spillable
from repro_torch.serving.pool.histpool import (COWDedup, HistoryPagePool,
                                               PendingDelta)
from repro_torch.serving.round_kv import round_kv


def _master_spillable(master: MasterCache) -> Spillable:
    """Move a Master's dense k/v between tiers, in place."""
    def get():
        return (master.k, master.v)

    def put(arrs):
        master.k, master.v = arrs
    return Spillable(get, put)


def _mirrors_spillable(handles: list) -> Spillable:
    """Move every mirror diff's value rows between tiers, in place (the
    index arrays are host numpy already and stay put)."""
    def get():
        arrs = []
        for h in handles:
            arrs.extend((h.diff.k_vals, h.diff.v_vals))
        return arrs

    def put(arrs):
        for i, h in enumerate(handles):
            h.diff.k_vals, h.diff.v_vals = arrs[2 * i], arrs[2 * i + 1]
    return Spillable(get, put)


@register_policy("tokendance")
class TokenDancePolicy(PICPolicy):
    """Collective reuse + Master-Mirror storage + page-sharing restore.

    ``paged_history=True`` (default) keeps restored histories PAGED
    through the collector: the family restore's page pool + per-agent
    page tables flow into ``collective_reuse``, whose recovery reads the
    pages per layer. ``False`` selects the dense oracle (a per-mirror
    gather back to dense entries).

    ``paged_attention=True`` (default) selects the collector's
    zero-densify path; ``False`` keeps the histories paged up to the
    collector and densifies them there (its parity oracle).

    ``incremental=True`` (default, requires ``paged_history``) keeps each
    family's restored pages alive ACROSS rounds in a
    :class:`HistoryPagePool` (owner ``hist:family:<fam>``): agent i's
    round-r history prefix-extends its round r-1 history, so round r
    reuses round r-1's pages for the prefix and restores only the round
    delta — the appended span (one ``trim_family(start=...)`` delta
    launch) plus the prefix blocks round r-1's recovery recomputed
    (copy-on-write from the reuse plan's per-agent selection). A pool
    whose family Master was evicted, or whose span no longer matches, is
    dropped and the next restore falls back to the full path (which
    re-creates the pool); spilled pool pages are reloaded through
    ``PoolManager.ensure_resident`` before any page is reused.

    One Master family per gather group, keyed by the group's member
    tuple.
    """

    collective = True

    def __init__(self, paged_history: bool = True,
                 paged_attention: bool = True,
                 incremental: bool = True) -> None:
        super().__init__()
        self.paged_history = paged_history
        self.paged_attention = paged_attention
        self.incremental = incremental and paged_history
        self.masters: Dict[tuple, MasterCache] = {}
        #: one persistent cross-round restore pool per Master family
        self.hist_pools: Dict[tuple, HistoryPagePool] = {}

    # ---------------------------------------------------------- restore
    def _restore_histories(self, ctx: RoundContext):
        """Rebuild each group member's history-segment cache from the
        previous round's Master-Mirror state plus its own output segment,
        one page-sharing launch per Master family (or the round delta
        only, from the family's cross-round pool). Sessions restore
        against the family they were COMPRESSED in (``Session.family``)."""
        rt = self.rt
        pending = [a for a in ctx.agent_ids
                   if rt.sessions[a].hist_entry is None
                   and rt.sessions[a].hist_pending is not None]
        families: Dict[tuple, list] = {}
        for a in pending:
            fam = rt.sessions[a].family
            if fam is not None and fam in self.masters:
                families.setdefault(fam, []).append(a)
        if not families:
            return 0.0, None
        t0 = time.perf_counter()
        infos = []
        for fi, (fam, members) in enumerate(families.items()):
            master = self.masters[fam]
            # the restore reads the family's compressed state and each
            # member's output segment — pull any of it back from the host
            # tier first
            fam_owner = self._fam_owner(fam)
            rt.manager.ensure_resident(f"td:master:{fam_owner}")
            rt.manager.ensure_resident(f"td:mirrors:{fam_owner}")
            for a in members:
                rt.manager.ensure_resident(f"out:{a}")
            mirrors = [a for a in members if not rt.sessions[a].is_master]
            # equal-length prompts give every family member the same span
            span_len = rt.sessions[members[0]].hist_pending[0]
            assert all(rt.sessions[a].hist_pending[0] == span_len
                       for a in members)
            gid = ctx.gid if len(families) == 1 else f"{ctx.gid}.f{fi}"
            if self.paged_history:
                info = None
                if self.incremental:
                    info = self._restore_incremental(
                        ctx, fam, master, members, mirrors, span_len)
                if info is None:
                    info = self._restore_paged(ctx, gid, master, members,
                                               mirrors, span_len, fam=fam)
                infos.append(info)
            else:
                infos.append(self._restore_dense(ctx, master, members,
                                                 mirrors, span_len))
        info = infos[0] if len(infos) == 1 else infos
        return time.perf_counter() - t0, info

    def _restore_paged(self, ctx: RoundContext, gid: str,
                       master: MasterCache, pending: list, mirrors: list,
                       span_len: int, fam: Optional[tuple] = None) -> dict:
        """One page-sharing family launch, trimmed to the history span;
        entries reference the pool.

        Full restore: the pool's pages are claimed from the manager
        BEFORE the launch (under pressure that evicts cold owners first),
        and the restore builds exactly the granted pages. Incremental
        mode: this is the pool BOOTSTRAP (and the fallback after an
        invalidation) — the pages persist in a :class:`HistoryPagePool`
        under the ``hist:family:<fam>`` owner, seeded with a table for
        EVERY member still compressed in this family, not only the ones
        restored now."""
        rt = self.rt
        cfg = rt.cfg
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        persist = self.incremental and fam is not None
        if persist:
            self._drop_hist_pool(fam)
            all_members = [a for a in fam if a in rt.sessions
                           and rt.sessions[a].family == fam
                           and rt.sessions[a].hist_pending is not None
                           and rt.sessions[a].hist_pending[0] == span_len]
            assert set(pending) <= set(all_members), (pending, all_members)
        else:
            all_members = pending
        mirrors_all = [a for a in all_members if not rt.sessions[a].is_master]
        if mirrors_all:
            handles = trim_family([rt.sessions[a].mirror for a in mirrors_all],
                                  span_len)
            bt = handles[0].diff.block_tokens
            n_pool = family_pool_pages(handles)
            if not persist:
                rt.manager.free(f"restore:family:{gid}")
                rt.manager.alloc_tokens(f"restore:family:{gid}", n_pool * bt,
                                        persistent=False)
            pool_k, pool_v, page_idx = fused_restore_family_shared(
                handles, n_pages=n_pool)
        else:
            # single-agent family: the pool is just the Master's blocks
            bt = rt.block_select or 32
            mk = _pad_to_blocks(master.k[:, :span_len], bt)
            mv = _pad_to_blocks(master.v[:, :span_len], bt)
            nb_ = mk.shape[1] // bt
            if not persist:
                rt.manager.free(f"restore:family:{gid}")
                rt.manager.alloc_tokens(f"restore:family:{gid}", nb_ * bt,
                                        persistent=False)
            pool_k = mk.reshape(L, nb_, bt, KV, hd)
            pool_v = mv.reshape(L, nb_, bt, KV, hd)
            if persist:   # the pool outlives the Master: own its pages
                pool_k, pool_v = pool_k.clone(), pool_v.clone()
            page_idx = np.zeros((0, nb_), np.int32)
        nb = -(-span_len // bt)
        master_row = np.arange(nb, dtype=np.int32)
        mirror_row = {a: i for i, a in enumerate(mirrors_all)}
        if persist:
            # the pages outlive the round: register the pool under its
            # persistent family owner so it spills/reloads as a unit and
            # competes in family-cost-aware eviction between rounds
            tables = {a: (master_row if rt.sessions[a].is_master
                          else page_idx[mirror_row[a]])
                      for a in all_members}
            hp = HistoryPagePool(fam, pool_k, pool_v, tables, span_len, bt,
                                 ctx.round_idx)
            self.hist_pools[fam] = hp
            rt.manager.alloc(hp.owner, hp.capacity, persistent=True,
                             spillable=hp.spillable())
        entry_bytes = 0
        dense_equiv = 0
        item = pool_k.element_size()
        for a in pending:
            s = rt.sessions[a]
            span_len, out_sid = s.hist_pending        # set in store()
            row = (master_row if s.is_master else page_idx[mirror_row[a]])
            nbh = -(-span_len // bt)
            out_e = rt.segment_index.get(out_sid)
            sp = np.concatenate([np.arange(span_len, dtype=np.int32),
                                 out_e.src_pos])
            s.hist_entry = PagedSegmentCacheEntry(
                sid=f"hist:{a}:{ctx.round_idx}", pool_k=pool_k,
                pool_v=pool_v, page_idx=np.asarray(row[:nbh], np.int32),
                src_pos=sp, seq_len=span_len, block_tokens=bt,
                tail_k=out_e.k, tail_v=out_e.v,
                producer=a, round_idx=ctx.round_idx)
            entry_bytes += s.hist_entry.nbytes()
            dense_equiv += 2 * L * (span_len + out_e.k.shape[1]) * KV * hd \
                * item
        # the family's shared pages are accounted ONCE, not once per mirror
        n_pool = int(pool_k.shape[1])
        pool_bytes = 2 * pool_k.numel() * item
        page_b = 2 * L * bt * KV * hd * item
        return {
            "paged": True,
            "incremental": False,           # full restore (O(S) pages)
            "n_restored": len(pending),
            "n_mirrors": len(mirrors),
            "nb": nb,                       # blocks per family member
            "pool_pages": n_pool,           # nb + M*ndb (shared once)
            "full_write_pages": (len(mirrors) + 1) * nb,  # un-shared cost
            "page_bytes": page_b,
            "bytes_materialized": pool_bytes + entry_bytes,
            "dense_equiv_bytes": dense_equiv,
        }

    # ------------------------------------------------ incremental restore
    def _drop_hist_pool(self, fam: tuple) -> None:
        """Invalidate a family's cross-round pool: forget the page tables
        and release the persistent owner from every tier."""
        pool = self.hist_pools.pop(fam, None)
        if pool is not None:
            self.rt.manager.free(pool.owner)

    def _restore_incremental(self, ctx: RoundContext, fam: tuple,
                             master: MasterCache, members: list,
                             mirrors: list, span_len: int) -> Optional[dict]:
        """O(round delta) restore from the family's persistent pool.

        Returns the restore ledger, or None when no valid pool exists —
        the caller then falls back to the full family restore, which
        re-creates the pool. Valid: the pool reaches ``span_len`` (it sits
        there, or the pending delta advances it there) and holds a table
        for every member being restored. Spilled pages are reloaded
        (``ensure_resident``) BEFORE any page is reused."""
        rt = self.rt
        pool = self.hist_pools.get(fam)
        if pool is None:
            return None
        pend = pool.pending
        valid = (all(a in pool.page_tables for a in members)
                 and ((pend is None and pool.span_len == span_len)
                      or (pend is not None
                          and pend.h_prev == pool.span_len
                          and pend.h_new == span_len)))
        if not valid:
            self._drop_hist_pool(fam)
            return None
        rt.manager.ensure_resident(pool.owner)
        bt = pool.block_tokens
        nb_prev = pool.span_len // bt
        new_span_pages = cow_pages = cow_dedup_hits = 0
        grown0 = pool.grown_pages
        if pend is not None:
            new_span_pages, cow_pages, cow_dedup_hits = \
                self._apply_pending(pool, fam, master)
            # capacity may have grown (or stayed put with recycled COW
            # pages) — re-account the persistent owner at its real size
            rt.manager.free(pool.owner)
            rt.manager.alloc(pool.owner, pool.capacity, persistent=True,
                             spillable=pool.spillable())
        assert pool.span_len == span_len, (pool.span_len, span_len)
        cfg = rt.cfg
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        nbh = -(-span_len // bt)
        item = pool.pool_k.element_size()
        entry_bytes = 0
        dense_equiv = 0
        reused = set()
        for a in members:
            s = rt.sessions[a]
            _, out_sid = s.hist_pending
            out_e = rt.segment_index.get(out_sid)
            row = pool.page_tables[a][:nbh]
            reused.update(int(p) for p in row[:nb_prev])
            sp = np.concatenate([np.arange(span_len, dtype=np.int32),
                                 out_e.src_pos])
            s.hist_entry = PagedSegmentCacheEntry.prefix_extension(
                sid=f"hist:{a}:{ctx.round_idx}",
                pool_k=pool.pool_k, pool_v=pool.pool_v,
                prior_page_idx=row[:nb_prev],
                delta_page_idx=row[nb_prev:nbh],
                src_pos=sp, seq_len=span_len, block_tokens=bt,
                tail_k=out_e.k, tail_v=out_e.v,
                producer=a, round_idx=ctx.round_idx)
            entry_bytes += s.hist_entry.nbytes()
            dense_equiv += 2 * L * (span_len + out_e.k.shape[1]) * KV * hd \
                * item
        pages_written = new_span_pages + cow_pages
        page_b = 2 * L * bt * KV * hd * item
        return {
            "paged": True,
            "incremental": True,
            "n_restored": len(members),
            "n_mirrors": len(mirrors),
            "nb": nbh,                       # blocks per family member
            "pool_pages": pages_written,     # counted restore work
            "pages_reused": len(reused),     # prefix pages NOT re-restored
            "new_span_pages": new_span_pages,
            "cow_pages": cow_pages,          # distinct pages written
            "cow_dedup_hits": cow_dedup_hits,  # COW writes shared, not stored
            "grown_pages": pool.grown_pages - grown0,
            "full_write_pages": (len(mirrors) + 1) * nbh,  # un-shared cost
            "page_bytes": page_b,
            "bytes_materialized": pages_written * page_b + entry_bytes,
            "dense_equiv_bytes": dense_equiv,
        }

    def _apply_pending(self, pool: HistoryPagePool, fam: tuple,
                       master: MasterCache):
        """Advance the pool from content(r-1) to content(r): restore the
        appended ``[h_prev, h_new)`` span through a delta-trimmed family
        launch (the Master's delta blocks written once) and copy-on-write
        the dirty prefix blocks from the round-r family. Every member's
        table advances together — also members not restored this round
        (admission may defer them). Every write lands in pages claimed
        from the free list here. Returns (new span pages, COW pages
        written, COW dedup hits)."""
        rt = self.rt
        cfg = rt.cfg
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        pend = pool.pending
        bt = pool.block_tokens
        h_prev, h_new = pend.h_prev, pend.h_new
        nb_prev, nb_new = h_prev // bt, -(-h_new // bt)
        fam_members = [a for a in fam if a in pool.page_tables]
        mirror_members = [a for a in fam_members
                          if not rt.sessions[a].is_master]
        # the round-r family may be wider than the pool (a bf16 model's
        # round-0 pool meets the f32 families recovery stores): widen the
        # pool, as a full restore from this family would hold it
        pool.promote(master.k.dtype)
        # --- appended span: ONE delta family launch into fresh pages ---
        m_pages = pool.alloc_pages(nb_new - nb_prev)
        if mirror_members:
            handles = trim_family(
                [rt.sessions[a].mirror for a in mirror_members],
                h_new, start=h_prev)
            M = len(handles)
            ndb = max(1, max(h.diff.n_blocks for h in handles))
            d_pages = pool.alloc_pages(M * ndb).reshape(M, ndb)
            pool.pool_k, pool.pool_v, rows = fused_restore_family_shared(
                handles, pool.pool_k, pool.pool_v,
                master_map=m_pages, diff_maps=d_pages)
            row_of = {a: np.asarray(rows[i], np.int32)
                      for i, a in enumerate(mirror_members)}
            allocated = np.concatenate([m_pages, d_pages.ravel()])
            new_span_pages = (nb_new - nb_prev) + M * ndb
        else:
            mk = _pad_to_blocks(master.k[:, h_prev:h_new], bt)
            mv = _pad_to_blocks(master.v[:, h_prev:h_new], bt)
            nb_d = mk.shape[1] // bt
            pool.write_pages(m_pages, mk.reshape(L, nb_d, bt, KV, hd),
                             mv.reshape(L, nb_d, bt, KV, hd))
            row_of = {}
            allocated = m_pages
            new_span_pages = nb_new - nb_prev
        for a in fam_members:
            row = (m_pages if rt.sessions[a].is_master else row_of[a])
            pool.incref(row)
            pool.page_tables[a] = np.concatenate(
                [pool.page_tables[a], row]).astype(np.int32)
        # padded diff rows of the launch that no table references are
        # immediately reusable
        pool.release_unreferenced(allocated)
        # --- dirty prefix blocks: copy-on-write from the round family ---
        # members that dirty the same block with bit-identical contents
        # share one freshly written page (refcount) instead of two
        wp, wk, wv = [], [], []
        dedup = COWDedup()
        for a in fam_members:
            blocks = pend.dirty.get(a)
            if blocks is None or blocks.size == 0:
                continue
            diff = None if rt.sessions[a].is_master \
                else rt.sessions[a].mirror.diff
            for b in [int(x) for x in blocks]:
                kb, vb = self._family_block(master, diff, b, bt)
                q = dedup.match(b, kb, vb)
                if q is None:
                    q = int(pool.alloc_pages(1)[0])
                    dedup.insert(b, kb, vb, q)
                    wp.append(q)
                    wk.append(kb)
                    wv.append(vb)
                old = int(pool.page_tables[a][b])
                pool.page_tables[a][b] = q
                pool.incref([q])
                pool.decref([old])
        if wp:
            pool.write_pages(np.asarray(wp, np.int32),
                             torch.stack(wk, dim=1), torch.stack(wv, dim=1))
        pool.span_len = h_new
        pool.round_idx = pend.round_idx
        pool.pending = None
        return new_span_pages, len(wp), dedup.hits

    @staticmethod
    def _family_block(master: MasterCache, diff, b: int, bt: int):
        """Block ``b`` of one member's round-family content: the mirror's
        diff row when the block deviates from the Master, else the
        Master's block — exactly what a full restore writes there."""
        if diff is not None:
            pos = np.flatnonzero(np.asarray(diff.block_idx) == b)
            if pos.size:
                return diff.k_vals[:, int(pos[0])], diff.v_vals[:, int(pos[0])]
        return master.k[:, b * bt:(b + 1) * bt], \
            master.v[:, b * bt:(b + 1) * bt]

    def _restore_dense(self, ctx: RoundContext, master: MasterCache,
                       pending: list, mirrors: list, span_len: int) -> dict:
        """Parity oracle: per-mirror gather back to dense entries. The
        collector then densifies nothing, but the work here is O(M*S)."""
        rt = self.rt
        restored = {}
        pool_bytes = 0
        if mirrors:
            handles = trim_family([rt.sessions[a].mirror for a in mirrors],
                                  span_len)
            S = handles[0].diff.seq_len
            pk_, pv_, page_idx = fused_restore_family_shared(handles)
            pool_bytes = 2 * pk_.numel() * pk_.element_size()
            for i, a in enumerate(mirrors):
                restored[a] = gather_pages(pk_, pv_, page_idx[i], S)
        entry_bytes = 0
        for a in pending:
            s = rt.sessions[a]
            span_len, out_sid = s.hist_pending        # set in store()
            if s.is_master:
                rk, rv = master.k, master.v
            else:
                rk, rv = restored[a]
            out_e = rt.segment_index.get(out_sid)
            hk = torch.cat([rk[:, :span_len], out_e.k], dim=1)
            hv = torch.cat([rv[:, :span_len], out_e.v], dim=1)
            sp = np.concatenate([np.arange(span_len, dtype=np.int32),
                                 out_e.src_pos])
            s.hist_entry = SegmentCacheEntry(
                sid=f"hist:{a}:{ctx.round_idx}", k=hk, v=hv, src_pos=sp,
                producer=a, round_idx=ctx.round_idx)
            entry_bytes += s.hist_entry.nbytes()
        return {
            "paged": False,
            "n_restored": len(pending),
            "n_mirrors": len(mirrors),
            "pool_pages": 0,
            "bytes_materialized": pool_bytes + entry_bytes,
            "dense_equiv_bytes": entry_bytes,
        }

    # ------------------------------------------------------------- store
    def store(self, ctx: RoundContext, cache: dict, outputs: np.ndarray,
              result: RecoveryResult, stats) -> None:
        kv = round_kv(cache)
        if kv is None:
            return
        rt = self.rt
        S, G = ctx.prompt_len, rt.gen_len
        aids = ctx.agent_ids
        hspan = ctx.layouts[0].spans[0]
        self._store_output_segments(ctx, kv, outputs)

        # Master-Mirror compression of the round family over the prefill
        # region [0, S); the decode tails are the output segments stored
        # above (new content, stored once and shared)
        plan = result.info.get("plan")
        master_idx = plan.master if plan is not None else 0
        pk_all, pv_all = kv.slice(0, S)         # [L, N, S, KV, hd]
        master, handles = build_round_family(
            aids, pk_all.transpose(0, 1), pv_all.transpose(0, 1),
            np.arange(S), master_idx, block_tokens=rt.block_select or 32)
        self.masters[ctx.group_key] = master
        stats.merge_reuse("compression", compression_stats(master, handles))
        hi = 0
        for i, a in enumerate(aids):
            s = rt.sessions[a]
            s.is_master = i == master_idx
            s.mirror = None if s.is_master else handles[hi]
            if not s.is_master:
                hi += 1
            s.family = ctx.group_key
            # history cache deferred: restored from Master+diff next round
            s.hist_entry = None
            s.hist_pending = (hspan.end - hspan.start,
                              segment_hash(outputs[i]))
        self._record_round_delta(ctx, plan, hspan)
        # evict masters no session references anymore (every member has
        # since been re-compressed into a newer family), with their
        # persistent ledger entries and their cross-round pool, whose
        # pages must never be read once their Master is gone
        for key in [k for k in self.masters if k != ctx.group_key
                    and not any(rt.sessions[m].family == k
                                for m in k if m in rt.sessions)]:
            del self.masters[key]
            rt.manager.free(f"td:master:{self._fam_owner(key)}")
            rt.manager.free(f"td:mirrors:{self._fam_owner(key)}")
            self._drop_hist_pool(key)
        # ledger: one dense master + sparse mirrors + the N output
        # segments, each registered with a Spillable so the tiered
        # manager can offload it under pressure
        fam = self._fam_owner(ctx.group_key)
        rt.manager.free(f"td:master:{fam}")
        rt.manager.alloc_tokens(
            f"td:master:{fam}", S, persistent=True,
            spillable=_master_spillable(master))
        mirror_bytes = sum(h.nbytes() for h in handles)
        rt.manager.free(f"td:mirrors:{fam}")
        rt.manager.alloc(
            f"td:mirrors:{fam}", -(-mirror_bytes // rt.pool.page_bytes()),
            persistent=True, spillable=_mirrors_spillable(handles))
        for i, a in enumerate(aids):
            rt.manager.free(f"out:{a}")
            rt.manager.alloc_tokens(
                f"out:{a}", G, persistent=True,
                spillable=entry_spillable(
                    rt.segment_index.get(segment_hash(outputs[i]))))

    def _record_round_delta(self, ctx: RoundContext, plan, hspan) -> None:
        """Arm the family's cross-round pool with this round's delta.

        The pool holds content(r-1) over ``[0, h_prev)``; the next restore
        must produce content(r) over ``[0, h_new)``. They differ exactly at
        the appended span ``[h_prev, h_new)`` and at the prefix blocks this
        round's recovery recomputed (the reuse plan's per-agent selected
        positions, block-granular because ``block_select`` aligns the
        selection to KV blocks). Anything that breaks the prefix-extension
        invariant (no collective plan, span regression, pool already
        armed, member mismatch) drops the pool instead: the next restore
        falls back to the full path."""
        if not self.incremental:
            return
        pool = self.hist_pools.get(ctx.group_key)
        if pool is None:
            return
        aids = ctx.agent_ids
        bt = pool.block_tokens
        h_prev, h_new = pool.span_len, hspan.end - hspan.start
        ok = (plan is not None
              and getattr(plan, "sel_idx_all", None) is not None
              and pool.pending is None
              and hspan.start == 0
              and h_prev % bt == 0 and h_new % bt == 0
              and h_new > h_prev
              and list(plan.request_ids) == list(aids)
              and set(aids) <= set(pool.page_tables))
        if not ok:
            self._drop_hist_pool(ctx.group_key)
            return
        sel_all = np.asarray(plan.sel_idx_all)
        dirty = {}
        for i, a in enumerate(aids):
            sel = sel_all[i]
            hb = np.unique(sel[sel < h_prev] // bt).astype(np.int32)
            if hb.size:
                dirty[a] = hb
        pool.pending = PendingDelta(h_prev=h_prev, h_new=h_new, dirty=dirty,
                                    round_idx=ctx.round_idx)

    @staticmethod
    def _fam_owner(group_key: tuple) -> str:
        """Stable pool-owner suffix for a Master family."""
        return "+".join(group_key)
