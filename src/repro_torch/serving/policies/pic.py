"""CacheBlend-style per-request PIC recovery, plus the cached-prompt
assembly shared with the collective TokenDance policy, in PyTorch.

``PICPolicy`` is the serial baseline (T2 in the paper's Fig. 7): N
independent RoPE-align + selection passes per round, with each agent's
history kept as a dense segment entry. Its ``plan`` /
``_assemble_cached`` machinery — shared-segment lookup, private-history
entries, dense-vs-paged ``priv`` construction — is what
``TokenDancePolicy`` inherits and drives collectively.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.collector import PagedPrivate
from repro_torch.core.pic import n_sel_for_blocks
from repro_torch.core.segments import (SHARED, PagedSegmentCacheEntry,
                                       SegmentCacheEntry, segment_hash)
from repro_torch.serving.policies.base import (RecoveryPlan, RecoveryResult,
                                               ReusePolicy, RoundContext,
                                               entry_spillable,
                                               register_policy, sync)
from repro_torch.serving.round_kv import round_kv


@register_policy("pic")
class PICPolicy(ReusePolicy):
    """Per-request position-independent cache recovery (CacheBlend)."""

    requires_attention = True
    requires_blocks = True
    #: subclasses flip this to drive ONE grouped pass per round
    collective = False
    #: paged histories take the collector's zero-densify path (False: the
    #: collector densifies them, its parity oracle)
    paged_attention = True

    # ------------------------------------------------------------- plan
    def plan(self, ctx: RoundContext) -> RecoveryPlan:
        if ctx.round_idx == 0:
            return RecoveryPlan(kind="recompute", ctx=ctx)
        t_restore, restore_info = self._restore_histories(ctx)
        assembled = self._assemble_cached(ctx)
        (_, _, _, smask, _, pmask, is_cached) = assembled
        if not bool(smask.any() or pmask.any()):
            return RecoveryPlan(kind="recompute", ctx=ctx,
                                t_restore=t_restore,
                                restore_info=restore_info)
        n_sel = n_sel_for_blocks(~is_cached, self.rt.block_select,
                                 self.rt.ratio)
        return RecoveryPlan(kind="reuse", ctx=ctx, n_sel=n_sel,
                            assembled=assembled, t_restore=t_restore,
                            restore_info=restore_info)

    def _restore_histories(self, ctx: RoundContext):
        """Hook for policies whose history caches live compressed between
        rounds (TokenDance)."""
        return 0.0, None

    def _assemble_cached(self, ctx: RoundContext):
        """Build the shared cached tensors + per-agent history caches.

        The shared KV is assembled in f32 whatever the model dtype, as
        the JAX engine assembles it: a bf16 model's recovery then runs in
        f32 (``layers.matmul`` promotes), and so do the caches it
        produces."""
        rt = self.rt
        cfg = rt.cfg
        dev = rt.device
        layouts, aids = ctx.layouts, ctx.agent_ids
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        S = layouts[0].length
        shared_k = torch.zeros((L, S, KV, hd), dtype=torch.float32,
                               device=dev)
        shared_v = torch.zeros_like(shared_k)
        src = np.arange(S, dtype=np.int32)
        shared_mask = np.zeros(S, bool)
        for span in layouts[0].spans:
            if span.kind != SHARED:
                continue
            e = rt.segment_index.get(span.sid)
            if e is None:
                continue
            # the shared block is some agent's output segment — pull it
            # back from the host tier if the manager spilled it
            if getattr(e, "producer", None) is not None:
                rt.manager.ensure_resident(f"out:{e.producer}")
            shared_k[:, span.start : span.end] = e.k
            shared_v[:, span.start : span.end] = e.v
            src[span.start : span.end] = e.src_pos
            shared_mask[span.start : span.end] = True

        # per-agent history caches (span 0 = private history): paged
        # entries referencing ONE family pool flow to the collector
        # without densification; anything else goes through the dense
        # oracle form
        hspan = layouts[0].spans[0]
        priv_mask = np.zeros(S, bool)
        priv = None
        for a in aids:                 # reload spilled dense histories
            rt.manager.ensure_resident(f"hist:{a}")
        entries = [rt.sessions[a].hist_entry for a in aids]
        if all(e is not None for e in entries) and hspan.end > hspan.start:
            priv_mask[hspan.start : hspan.end] = True
            paged = [isinstance(e, PagedSegmentCacheEntry) for e in entries]
            if all(paged) and all(e.pool_k is entries[0].pool_k
                                  for e in entries):
                priv = self._paged_priv(entries, hspan, S, priv_mask)
            else:
                entries = [e.materialize() if isinstance(
                    e, PagedSegmentCacheEntry) else e for e in entries]
                priv = self._dense_priv(entries, hspan, S, priv_mask)
        is_cached = shared_mask | priv_mask

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        return (shared_k, shared_v, on_dev(src), on_dev(shared_mask),
                priv, on_dev(priv_mask), is_cached)

    def _dense_priv(self, entries, hspan, S: int, priv_mask) -> tuple:
        """Dense private caches in f32 (as the shared KV): the
        collector's ``(pk [N,L,S,KV,hd], pv, psrc [N,S], pmask [S])``
        tuple."""
        cfg = self.rt.cfg
        dev = self.rt.device
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        N = len(entries)
        pk = torch.zeros((N, L, S, KV, hd), dtype=torch.float32, device=dev)
        pv = torch.zeros_like(pk)
        srcs = np.tile(np.arange(S, dtype=np.int32), (N, 1))
        for i, e in enumerate(entries):
            assert e.k.shape[1] == len(hspan), (e.k.shape, len(hspan))
            pk[i, :, hspan.start : hspan.end] = e.k
            pv[i, :, hspan.start : hspan.end] = e.v
            srcs[i, hspan.start : hspan.end] = e.src_pos
        return (pk, pv, torch.as_tensor(srcs, device=dev),
                torch.as_tensor(priv_mask, device=dev))

    def _paged_priv(self, entries, hspan, S: int, priv_mask):
        """Paged private caches: ONE family page pool + per-agent page
        tables (plus each agent's dense output tail)."""
        dev = self.rt.device
        e0 = entries[0]
        span_len, T = e0.seq_len, e0.tail_len
        assert span_len + T == len(hspan), (span_len, T, len(hspan))
        for e in entries:
            assert e.seq_len == span_len and e.tail_len == T, \
                "family entries must share the span layout"
        rows = np.stack([np.asarray(e.page_idx) for e in entries])
        srcs = np.tile(np.arange(S, dtype=np.int32), (len(entries), 1))
        for i, e in enumerate(entries):
            srcs[i, hspan.start : hspan.end] = e.src_pos
        tail_k = tail_v = None
        if T:
            tail_k = torch.stack([e.tail_k for e in entries])
            tail_v = torch.stack([e.tail_v for e in entries])
        return PagedPrivate(
            pool_k=e0.pool_k, pool_v=e0.pool_v,
            page_idx=torch.as_tensor(rows, device=dev),
            src=torch.as_tensor(srcs, device=dev),
            mask=torch.as_tensor(priv_mask, device=dev), start=hspan.start,
            span_len=span_len, tail_k=tail_k, tail_v=tail_v)

    # ---------------------------------------------------------- recover
    def recover(self, plan: RecoveryPlan,
                tokens: torch.Tensor) -> RecoveryResult:
        if plan.kind == "recompute":
            return self._recover_recompute(tokens)
        rt = self.rt
        aids, n_sel = plan.ctx.agent_ids, plan.n_sel
        (sk, sv, src, smask, priv, _, _) = plan.assembled
        N, S = tokens.shape
        if not self.collective and isinstance(priv, PagedPrivate):
            # the serial baseline consumes dense priv tuples only
            priv = priv.materialize(S)
        if self.collective:
            key = ("coll", N, S, n_sel, self.paged_attention)
            if key not in rt.warm:
                with spans.span("policy.recover.warm"):
                    rt.collector.collective_reuse(
                        aids, tokens, sk, sv, src, smask, n_sel, priv,
                        paged_attention=self.paged_attention)
                rt.warm.add(key)
            p0 = rt.collector.align_passes
            with spans.span("policy.recover", timed=True) as sp:
                res = rt.collector.collective_reuse(
                    aids, tokens, sk, sv, src, smask, n_sel, priv,
                    paged_attention=self.paged_attention)
                sync(rt.device)
            dt = sp.host_s
            k, v, logits = (res.pic.recovered_k, res.pic.recovered_v,
                            res.pic.logits)
            info = {"n_sel": n_sel, "plan": res.plan,
                    "align_passes": rt.collector.align_passes - p0}
        else:
            key = ("serial", S, n_sel)
            if key not in rt.warm:
                with spans.span("policy.recover.warm"):
                    rt.collector.serial_reuse(
                        aids[:1], tokens[:1], sk, sv, src, smask, n_sel,
                        None if priv is None else tuple(
                            x[:1] if i < 3 else x
                            for i, x in enumerate(priv)))
                rt.warm.add(key)
            p0 = rt.collector.align_passes
            with spans.span("policy.recover", timed=True) as sp:
                results = rt.collector.serial_reuse(aids, tokens, sk, sv,
                                                    src, smask, n_sel, priv)
                sync(rt.device)
            dt = sp.host_s
            k = torch.cat([r.recovered_k for r in results], dim=1)
            v = torch.cat([r.recovered_v for r in results], dim=1)
            logits = torch.cat([r.logits for r in results], dim=0)
            info = {"n_sel": n_sel,
                    "align_passes": rt.collector.align_passes - p0}
        return RecoveryResult(logits, {"k": k, "v": v}, dt, info)

    # ------------------------------------------------------------- store
    def _store_output_segments(self, ctx: RoundContext, kv,
                               outputs: np.ndarray) -> None:
        """Each agent's output block O_i, shared next round (§4.1). The
        slice is a page gather out of the round pool (a copy)."""
        rt = self.rt
        S, G = ctx.prompt_len, rt.gen_len
        ok, ov = kv.slice(S, S + G)       # [L, N, G, KV, hd]
        for i, a in enumerate(ctx.agent_ids):
            sid = segment_hash(outputs[i])
            rt.segment_index.put(SegmentCacheEntry(
                sid=sid, k=ok[:, i].contiguous(), v=ov[:, i].contiguous(),
                src_pos=np.arange(S, S + G, dtype=np.int32),
                producer=a, round_idx=ctx.round_idx))

    def store(self, ctx: RoundContext, cache: dict, outputs: np.ndarray,
              result: RecoveryResult, stats) -> None:
        kv = round_kv(cache)
        if kv is None:
            return
        rt = self.rt
        S, G = ctx.prompt_len, rt.gen_len
        hspan = ctx.layouts[0].spans[0]
        self._store_output_segments(ctx, kv, outputs)
        # CacheBlend keeps dense segment entries per agent; only the kept
        # regions (history span + output block) are ever gathered dense
        hk_all, hv_all = kv.slice(hspan.start, hspan.end)
        ok_all, ov_all = kv.slice(S, S + G)
        for i, a in enumerate(ctx.agent_ids):
            hk = torch.cat([hk_all[:, i], ok_all[:, i]], dim=1)
            hv = torch.cat([hv_all[:, i], ov_all[:, i]], dim=1)
            sp = np.concatenate([
                np.arange(hspan.start, hspan.end, dtype=np.int32),
                np.arange(S, S + G, dtype=np.int32)])
            rt.sessions[a].hist_entry = SegmentCacheEntry(
                sid=f"hist:{a}:{ctx.round_idx}", k=hk, v=hv, src_pos=sp,
                producer=a, round_idx=ctx.round_idx)
            rt.manager.free(f"hist:{a}")
            rt.manager.alloc_tokens(f"hist:{a}", hk.shape[1], persistent=True,
                                    spillable=entry_spillable(
                                        rt.sessions[a].hist_entry))
            rt.manager.free(f"out:{a}")
            rt.manager.alloc_tokens(f"out:{a}", G, persistent=True,
                                    spillable=entry_spillable(
                                        rt.segment_index.get(
                                            segment_hash(outputs[i]))))
