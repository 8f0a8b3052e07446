"""KV Collector — collective KV cache reuse over an All-Gather round
(paper §4.2, Fig. 7), in PyTorch.

Instead of N per-request reuse passes, the collector groups compatible
requests and performs ONE shared RoPE alignment and ONE batched
important-position selection for the whole group. The reuse plan it
emits (group membership, per-request deviations, Master choice) is the
bridge into Diff-Aware Storage (§4.3).

Private histories may arrive PAGED (:class:`PagedPrivate`): the family
page pool of the §4.4 restore plus per-request page tables, consumed by
the recovery pass without densification. ``_densify_paged`` is the
parity oracle. ``serial_reuse`` is the per-request baseline the serial
PIC policy runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pic import PagedHistory, PICResult, pic_prefill


@dataclass
class ReusePlan:
    """Metadata bridging collective reuse to Diff-Aware Storage."""

    request_ids: List[str]
    master: int                  # index into request_ids
    sel_idx: np.ndarray          # [n_sel] first request's recomputed positions
    deviations: np.ndarray       # [N] total per-request deviation
    prompt_len: int
    n_sel: int
    #: [N, n_sel] per-request recomputed positions
    sel_idx_all: Optional[np.ndarray] = None


@dataclass
class CollectiveResult:
    plan: ReusePlan
    pic: PICResult               # batched over the group


@dataclass
class PagedPrivate:
    """Per-request private history handed to the collector in PAGED form.

    Shapes (N requests, prompt length S):
      pool_k/pool_v: [L, P, bt, KV, hd] — family-shared page pools.
      page_idx:      int32 [N, nbh] — request n's logical block b lives in
                     pool page ``page_idx[n, b]``; covers the first
                     ``span_len`` tokens.
      tail_k/tail_v: optional [N, L, T, KV, hd] — dense suffix right after
                     the paged span (last round's output blocks).
      src:           int32 [N, S] — source positions of every cached value
                     (identity outside the private span).
      mask:          bool [S] — True on ``[start, start + span_len + T)``.
    """

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    page_idx: torch.Tensor       # int32 [N, nbh]
    src: torch.Tensor            # int32 [N, S]
    mask: torch.Tensor           # bool [S]
    start: int
    span_len: int
    tail_k: Optional[torch.Tensor] = None   # [N, L, T, KV, hd]
    tail_v: Optional[torch.Tensor] = None

    @property
    def tail_len(self) -> int:
        return 0 if self.tail_k is None else int(self.tail_k.shape[2])

    def identity_span_src(self) -> bool:
        """True iff the paged span's source positions equal its targets
        (``src[:, start+i] == start+i``): pool pages need no realignment."""
        span = self.src[:, self.start : self.start + self.span_len].cpu().numpy()
        want = np.arange(self.start, self.start + self.span_len,
                         dtype=span.dtype)
        return bool(np.array_equal(span, np.broadcast_to(want, span.shape)))

    def fast_path_ok(self) -> bool:
        """Gate of the zero-densify path: the span needs no realignment AND
        ``mask`` is True exactly on the span+tail region the fast path
        writes. Checked once per bundle (host copies of small tables)."""
        cached = self.__dict__.get("_fast_ok")
        if cached is None:
            mask = self.mask.cpu().numpy()
            region = np.zeros(mask.shape[0], bool)
            region[self.start : self.start + self.span_len + self.tail_len] \
                = True
            cached = (self.span_len > 0
                      and bool(np.array_equal(mask, region))
                      and self.identity_span_src())
            self.__dict__["_fast_ok"] = cached
        return cached

    def materialize(self, S: int) -> tuple:
        """Dense parity oracle: ``(pk, pv, psrc, pmask)`` with ``pk``/``pv``
        ``[N, L, S, KV, hd]``, as the serial baseline consumes them."""
        pk, pv = _densify_paged(
            self.pool_k, self.pool_v, self.page_idx, self.tail_k,
            self.tail_v, S=S, start=self.start, span_len=self.span_len)
        return pk, pv, self.src, self.mask


def _densify_paged(pool_k, pool_v, page_idx, tail_k, tail_v, *,
                   S: int, start: int, span_len: int):
    """Gather paged private histories into the dense per-request layout
    ``[N, L, S, KV, hd]`` (zeros outside the private span) — the parity
    oracle, pure data movement through ``restore.gather_pages``."""
    from repro_torch.core.restore import gather_pages

    L, _, bt, KV, hd = pool_k.shape
    N = page_idx.shape[0]
    pk = torch.zeros((N, L, S, KV, hd), dtype=pool_k.dtype,
                     device=pool_k.device)
    pv = torch.zeros_like(pk)
    rows = page_idx.cpu().numpy()
    for n in range(N):
        gk, gv = gather_pages(pool_k, pool_v, rows[n], span_len)
        pk[n, :, start : start + span_len] = gk
        pv[n, :, start : start + span_len] = gv
    if tail_k is not None:
        T = tail_k.shape[2]
        pk[:, :, start + span_len : start + span_len + T] = tail_k
        pv[:, :, start + span_len : start + span_len + T] = tail_v
    return pk, pv


@dataclass(frozen=True)
class GroupKey:
    """Compatibility key: same prompt length + same cached-span layout
    (+ the same gather-source set under a topology)."""

    prompt_len: int
    layout: Tuple[bool, ...]     # is_cached mask
    sources: Tuple[int, ...] = ()

    @classmethod
    def of(cls, prompt_len: int, is_cached: np.ndarray,
           sources: Tuple[int, ...] = ()) -> "GroupKey":
        return cls(prompt_len, tuple(bool(b) for b in is_cached), sources)


def group_compatible(
    requests: Sequence[Tuple[str, int, np.ndarray]],
    topology=None,
) -> List[List[str]]:
    """Group (request_id, prompt_len, is_cached) triples into compatible
    sets; incompatible requests fall into their own group. With a gather
    topology, requests also split by gather-source set."""
    src = ({} if topology is None
           else topology.sources([rid for rid, _, _ in requests]))
    groups: Dict[GroupKey, List[str]] = {}
    for rid, plen, mask in requests:
        key = GroupKey.of(plen, mask, src.get(rid, ()))
        groups.setdefault(key, []).append(rid)
    return list(groups.values())


class KVCollector:
    """Drives collective PIC recovery for round groups.

    Knobs: ``check_layer`` (deviation-measurement layer),
    ``recompute_ratio`` (fraction of cached positions recomputed),
    ``block_select`` (>0 selects whole token blocks of that size),
    ``pooled_selection`` (one pooled selected set per group in
    :meth:`collective_reuse` — beyond the paper, off by default).
    ``align_passes`` counts one unit per RoPE-align + selection pass.
    """

    def __init__(self, params: dict, cfg: ModelConfig, *, check_layer: int = 1,
                 recompute_ratio: float = 0.15, block_select: int = 0,
                 pooled_selection: bool = False):
        self.params = params
        self.cfg = cfg
        self.check_layer = min(check_layer, cfg.n_layers - 1)
        self.recompute_ratio = recompute_ratio
        self.block_select = block_select
        self.pooled_selection = pooled_selection
        self.align_passes = 0

    @staticmethod
    def _priv_args(priv, paged_attention: bool = True) -> Tuple[str, dict]:
        """(priv_mode, ``pic_prefill`` keyword args) for a ``priv`` that is
        None, a dense tuple ``(pk, pv, psrc, pmask)`` or a
        :class:`PagedPrivate`. A ``PagedPrivate`` takes the zero-densify
        path ("paged") when ``paged_attention`` is on and its structure
        allows it, else the densify oracle ("paged_densify")."""
        if priv is None:
            return "none", {}
        if isinstance(priv, PagedPrivate):
            if paged_attention and priv.fast_path_ok():
                return "paged", {"priv_hist": PagedHistory(
                    pool_k=priv.pool_k, pool_v=priv.pool_v,
                    page_idx=priv.page_idx, src=priv.src, start=priv.start,
                    span_len=priv.span_len, tail_k=priv.tail_k,
                    tail_v=priv.tail_v), "priv_mask": priv.mask}
            pk, pv = _densify_paged(
                priv.pool_k, priv.pool_v, priv.page_idx, priv.tail_k,
                priv.tail_v, S=priv.src.shape[1], start=priv.start,
                span_len=priv.span_len)
            return "paged_densify", {"priv_k": pk, "priv_v": pv,
                                     "priv_src": priv.src,
                                     "priv_mask": priv.mask}
        pk, pv, psrc, pmask = priv
        return "dense", {"priv_k": pk, "priv_v": pv, "priv_src": psrc,
                         "priv_mask": pmask}

    def collective_reuse(
        self,
        request_ids: List[str],
        tokens: torch.Tensor,        # [N, S]
        cached_k: torch.Tensor,      # [L, S, KV, hd]
        cached_v: torch.Tensor,
        src_pos: torch.Tensor,       # [S] int32
        shared_mask: torch.Tensor,   # [S] bool
        n_sel: int,
        priv=None,
        paged_attention: bool = True,
    ) -> CollectiveResult:
        """One collective recovery pass for the whole round group: ONE RoPE
        alignment of the group-shared blocks and ONE batched selection.
        ``cached_k/v`` hold the shared KV at prompt positions (zeros where
        uncached); ``n_sel`` is the recomputed-token budget (a multiple of
        ``block_select``). Returns the recovered caches ``[L, N, S, KV,
        hd]`` and logits, and the plan (Master = lowest total deviation
        over shared positions)."""
        self.align_passes += 1
        _, kw = self._priv_args(priv, paged_attention)
        res = pic_prefill(
            self.params, self.cfg, tokens, cached_k, cached_v, src_pos,
            shared_mask, n_sel, check_layer=self.check_layer,
            pooled_selection=self.pooled_selection,
            block_select=self.block_select, **kw)
        dev = torch.where(shared_mask[None], res.deviation, 0.0).sum(
            dim=1).cpu().numpy()
        master = int(np.argmin(dev))  # closest to the group's common structure
        sel_all = res.sel_idx.cpu().numpy()
        plan = ReusePlan(list(request_ids), master, sel_all[0], dev,
                         tokens.shape[1], n_sel, sel_idx_all=sel_all)
        return CollectiveResult(plan, res)

    def serial_reuse(
        self,
        request_ids: List[str],
        tokens: torch.Tensor,        # [N, S]
        cached_k: torch.Tensor,      # [L, S, KV, hd]
        cached_v: torch.Tensor,
        src_pos: torch.Tensor,       # [S] int32
        shared_mask: torch.Tensor,   # [S] bool
        n_sel: int,
        priv=None,
    ) -> List[PICResult]:
        """Per-request baseline (T2 path): N independent reuse passes, each
        repeating RoPE alignment and important-position selection. Same
        contracts as :meth:`collective_reuse`; returns one
        :class:`PICResult` per request (each with B = 1 leading axes). A
        :class:`PagedPrivate` ``priv`` is densified up front — the
        baseline pays the full per-request materialization the
        collective paged path avoids."""
        if isinstance(priv, PagedPrivate):
            priv = priv.materialize(tokens.shape[1])
        self.align_passes += tokens.shape[0]
        out = []
        for i in range(tokens.shape[0]):
            kw = {}
            if priv is not None:
                pk, pv, psrc, pmask = priv
                kw = dict(priv_k=pk[i : i + 1], priv_v=pv[i : i + 1],
                          priv_src=psrc[i : i + 1], priv_mask=pmask)
            out.append(pic_prefill(
                self.params, self.cfg, tokens[i : i + 1], cached_k, cached_v,
                src_pos, shared_mask, n_sel, check_layer=self.check_layer,
                block_select=self.block_select, **kw))
        return out
