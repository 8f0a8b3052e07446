"""The paper's policy in PyTorch: collective recovery (one shared pass per
gather group) + Master-Mirror diff storage + page-sharing family restore.

Inherits the cached-prompt assembly and collective recovery from
``PICPolicy``; adds Diff-Aware Storage after the round (§4.3) and the
family restore before the next one (§4.4).

This port covers the full-restore path (``incremental=False`` in the JAX
package): every round rebuilds each family's history pages from its
Master and mirror diffs in one page-sharing launch. The cross-round
incremental restore, the dense-history oracle (``paged_history=False``)
and the collector's densify oracle as a policy option
(``paged_attention=False``) are not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from repro_torch.core.diff_store import (MasterCache, _pad_to_blocks,
                                         build_round_family,
                                         compression_stats, trim_family)
from repro_torch.core.restore import (family_pool_pages,
                                      fused_restore_family_shared)
from repro_torch.core.segments import PagedSegmentCacheEntry, segment_hash
from repro_torch.serving.policies.base import (RecoveryResult, RoundContext,
                                               entry_spillable)
from repro_torch.serving.policies.pic import PICPolicy
from repro_torch.serving.pool import Spillable
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


class TokenDancePolicy(PICPolicy):
    """Collective reuse + Master-Mirror storage + page-sharing restore.

    Restored histories stay PAGED through the collector: the family
    restore's page pool + per-agent page tables flow into
    ``collective_reuse``, whose recovery reads the pages per layer. One
    Master family per gather group, keyed by the group's member tuple.
    ``incremental=True`` (the JAX default) raises until the cross-round
    restore is ported.
    """

    name = "tokendance"

    def __init__(self, incremental: bool = False) -> None:
        super().__init__()
        if incremental:
            raise NotImplementedError(
                "repro_torch ports the full restore (incremental=False) "
                "only; the cross-round incremental restore is not ported")
        self.masters: Dict[tuple, MasterCache] = {}

    # ---------------------------------------------------------- restore
    def _restore_histories(self, ctx: RoundContext):
        """Rebuild each group member's history-segment cache from the
        previous round's Master-Mirror state plus its own output segment,
        one page-sharing launch per Master family. Sessions restore
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
            infos.append(self._restore_paged(ctx, gid, master, members,
                                             mirrors, span_len))
        info = infos[0] if len(infos) == 1 else infos
        return time.perf_counter() - t0, info

    def _restore_paged(self, ctx: RoundContext, gid: str,
                       master: MasterCache, pending: list, mirrors: list,
                       span_len: int) -> dict:
        """One page-sharing family launch, trimmed to the history span;
        entries reference the pool. The pool's pages are claimed from the
        manager BEFORE the launch (under pressure that evicts cold owners
        first), and the restore builds exactly the granted pages."""
        rt = self.rt
        cfg = rt.cfg
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        if mirrors:
            handles = trim_family([rt.sessions[a].mirror for a in mirrors],
                                  span_len)
            bt = handles[0].diff.block_tokens
            n_pool = family_pool_pages(handles)
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
            rt.manager.free(f"restore:family:{gid}")
            rt.manager.alloc_tokens(f"restore:family:{gid}", nb_ * bt,
                                 persistent=False)
            pool_k = mk.reshape(L, nb_, bt, KV, hd)
            pool_v = mv.reshape(L, nb_, bt, KV, hd)
            page_idx = np.zeros((0, nb_), np.int32)
        nb = -(-span_len // bt)
        master_row = np.arange(nb, dtype=np.int32)
        mirror_row = {a: i for i, a in enumerate(mirrors)}
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
        # evict masters no session references anymore (every member has
        # since been re-compressed into a newer family), with their
        # persistent ledger entries
        for key in [k for k in self.masters if k != ctx.group_key
                    and not any(rt.sessions[m].family == k
                                for m in k if m in rt.sessions)]:
            del self.masters[key]
            rt.manager.free(f"td:master:{self._fam_owner(key)}")
            rt.manager.free(f"td:mirrors:{self._fam_owner(key)}")
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

    @staticmethod
    def _fam_owner(group_key: tuple) -> str:
        """Stable pool-owner suffix for a Master family."""
        return "+".join(group_key)
