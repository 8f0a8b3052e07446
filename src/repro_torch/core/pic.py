"""Position-independent caching with CacheBlend-style selective
recomputation (paper §2.2), the recovery backend of collective reuse
(§4.2), in PyTorch.

Recovery of a request group:

  1. RoPE-align cached keys from their source to their target positions
     — ONE ``rope_align`` launch for the group's shared blocks over every
     layer, and one for the decode tails of paged private histories.
  2. Run the first ``check_layer + 1`` layers fresh (full-sequence flash
     attention) and measure each position's key deviation on the check
     layer.
  3. Select the most deviating token blocks (fresh blocks always win) and
     recompute ONLY those rows through the remaining layers; their
     attention runs on the flash kernel with the selected positions as
     query positions.

Private histories arrive dense (``priv_k``/``priv_v``) or as a
:class:`PagedHistory` whose pages are read per layer at the point of use.
The two forms give identical results (pure data movement plus a skipped
identity rotation).

Row writes (``index_put_``) go only into per-layer tensors built fresh by
``base_layer``, never into a pool, a cached entry or a shared tensor.

``pic_prefill`` takes JAX's ``shard`` hook, called at JAX's tag sites: the
fresh layers' (``models.transformer.block_full``), each selective layer's
attention output and MLP / MoE, and the logits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope,
    attention,
    feed_forward,
    lookup,
    noshard,
    shard_index,
    out_proj,
    project_qkv,
    rmsnorm,
    rope_cos_sin,
)
from repro_torch.models.transformer import (block_full, layer, logits_of,
                                            sharded)

BIG = 1.0e30


@dataclass
class PagedHistory:
    """Private histories in PAGED form: pools ``[L, P, bt, KV, hd]``,
    ``page_idx`` int [B, nbh], ``src`` int32 [B, S] (read for the tail
    rotation only), static placement ``start``/``span_len`` of the paged
    span, and optional dense tails ``[B, L, T, KV, hd]``. The span's
    source positions equal its targets (the collector gates on it), so
    pool pages need no rotation."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    page_idx: torch.Tensor
    src: torch.Tensor
    start: int
    span_len: int
    tail_k: Optional[torch.Tensor] = None
    tail_v: Optional[torch.Tensor] = None

    @property
    def tail_len(self) -> int:
        return 0 if self.tail_k is None else int(self.tail_k.shape[2])


@dataclass
class PICResult:
    """Output of one recovery pass (batched over a request group)."""

    recovered_k: torch.Tensor   # [L, B, S, KV, hd]
    recovered_v: torch.Tensor   # [L, B, S, KV, hd]
    deviation: torch.Tensor     # [B, S]   check-layer key deviation (0 at fresh)
    sel_idx: torch.Tensor       # [B, n_sel] recomputed positions (sorted)
    logits: torch.Tensor        # [B, V]   last-position logits
    hidden_sel: torch.Tensor    # [B, n_sel, D] final hidden at selected positions


def align_cached_keys(cached_k: torch.Tensor, src_pos: torch.Tensor,
                      tgt_pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE-align cached keys ``[L, S, KV, hd]`` (or ``[B, L, S, KV, hd]``
    with per-request positions ``[B, S]``) from src to target positions:
    ONE ``rope_align`` launch over all layers."""
    delta = (tgt_pos - src_pos).to(torch.int32)
    return ops.rope_align(cached_k.contiguous(), delta, theta)


def _scatter_rows(base: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """``base[b, idx[b]] = vals[b]`` in place (base is a fresh tensor). A
    DTensor base (its sequence may be split) is written by
    :func:`_scatter_local` and returned as a new DTensor."""
    if isinstance(base, DTensor):
        return _scatter_local(base, vals, idx)
    rows = torch.arange(base.shape[0], device=base.device)[:, None]
    base[rows, idx] = vals
    return base


def _scatter_local(base, vals, idx):
    """:func:`_scatter_rows` on local shards: the batch split as
    ``base``'s, each rank's sequence shard written with the rows that fall
    inside it; the others go to a spare row that is dropped (a fixed
    shape: no host read of ``idx``)."""
    mesh = base.device_mesh
    bp = [pl if pl in (Shard(0), Shard(1)) else Replicate()
          for pl in base.placements]
    rp = [Shard(0) if pl == Shard(0) else Replicate() for pl in bp]
    seq = [i for i, pl in enumerate(bp) if pl == Shard(1)]
    n_local = base.shape[1] // math.prod(mesh.size(i) for i in seq)
    s0 = shard_index(mesh, seq) * n_local

    def write(b, v, i):
        at = i.long() - s0
        at = torch.where((at >= 0) & (at < n_local), at, n_local)
        out = F.pad(b, (0, 0, 0, 0, 0, 1))
        rows = torch.arange(b.shape[0], device=b.device)[:, None]
        out[rows, at] = v.to(out.dtype)
        return out[:, :n_local]

    if not isinstance(idx, DTensor):
        idx = distribute_tensor(idx, mesh, [Replicate()] * mesh.ndim,
                                src_data_rank=None)
    return local_map(write, out_placements=bp, in_placements=(bp, rp, rp),
                     device_mesh=mesh, redistribute_inputs=True)(
        base, vals, idx)


def _selective_block(h_sel, p, cfg, *, sel_pos, cos_sel, sin_sel,
                     k_base, v_base, sel_idx, shard=noshard):
    """Recompute one layer at the selected positions only: the selected
    rows' fresh K/V overwrite the (fresh, per-layer) base, then the
    selected queries attend over the merged KV (with the config's logit
    soft cap); an MoE layer routes the selected rows as groups of their
    own, as JAX's selective block does."""
    x = rmsnorm(h_sel, p["ln1"], cfg.rmsnorm_eps)
    q, k, v = project_qkv(x, p["attn"], cfg)
    q = apply_rope(q, cos_sel, sin_sel)
    k = apply_rope(k, cos_sel, sin_sel)
    k_merged = _scatter_rows(k_base, k, sel_idx)
    v_merged = _scatter_rows(v_base, v, sel_idx)
    o = attention(q, k_merged, v_merged, q_pos=sel_pos,
                  window=k_merged.shape[1], softcap=cfg.attn_logit_softcap)
    h_sel, _ = feed_forward(h_sel + shard(out_proj(o, p["attn"]),
                                          "act_resid"), p, cfg, shard)
    return h_sel, k_merged, v_merged


def _paged_base_layer(ph: PagedHistory, aligned_k: torch.Tensor,
                      shared_v: torch.Tensor, B: int, theta: float):
    """``base_layer(l) -> (k_l, v_l)`` ``[B, S, KV, hd]``, fresh tensors
    assembled from the group-shared aligned blocks, the paged span read
    out of ``pool[l][page_idx]`` (no rotation) and the realigned tail."""
    L, _, bt, KV, hd = ph.pool_k.shape
    nbh = ph.page_idx.shape[1]
    T = ph.tail_len
    s0, ts = ph.start, ph.start + ph.span_len
    pages = ph.page_idx.long()
    al_tail_k = None
    if T:
        # the tail is last round's decode output cached at last round's
        # positions — the only part of the paged history that rotates
        tail_tgt = torch.arange(ts, ts + T, dtype=torch.int32,
                                device=ph.src.device)
        al_tail_k = align_cached_keys(ph.tail_k, ph.src[:, ts:ts + T],
                                      tail_tgt[None], theta)

    def base_layer(l):
        S = aligned_k.shape[1]
        k_l = aligned_k[l].expand(B, S, KV, hd).clone()
        v_l = shared_v[l].expand(B, S, KV, hd).clone()
        span = slice(None, ph.span_len)
        k_l[:, s0:ts] = ph.pool_k[l][pages].reshape(B, nbh * bt, KV, hd)[:, span]
        v_l[:, s0:ts] = ph.pool_v[l][pages].reshape(B, nbh * bt, KV, hd)[:, span]
        if T:
            k_l[:, ts:ts + T] = al_tail_k[:, l]
            v_l[:, ts:ts + T] = ph.tail_v[:, l]
        return k_l, v_l

    return base_layer


def _select_blocks(scores: torch.Tensor, n_sel: int, bt: int) -> torch.Tensor:
    """The ``n_sel // bt`` highest-scoring token blocks of each row, as
    sorted token indices ``[B, n_sel]`` (a ragged tail block clipped to
    S - 1). Ties go to the LOWER block index, as ``jax.lax.top_k`` gives
    them: a stable descending sort, first k."""
    B, S = scores.shape
    assert n_sel % bt == 0, "n_sel must be a multiple of block_select"
    bscores = F.pad(scores, (0, (-S) % bt)).reshape(B, -1, bt).sum(dim=-1)
    bidx = torch.sort(bscores, dim=-1, descending=True,
                      stable=True).indices[:, : n_sel // bt]
    idx = bidx[:, :, None] * bt + torch.arange(bt, device=scores.device)
    return torch.sort(idx.reshape(B, n_sel).clamp(max=S - 1), dim=-1).values


def pic_prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,         # [B, S] — the request group
    shared_k: torch.Tensor,       # [L, S, KV, hd] group-shared cached keys
    shared_v: torch.Tensor,       # [L, S, KV, hd]
    shared_src: torch.Tensor,     # [S] int32 source positions of shared values
    shared_mask: torch.Tensor,    # [S] bool shared-cached positions
    n_sel: int,                   # number of recomputed positions
    *,
    priv_k: Optional[torch.Tensor] = None,     # [B, L, S, KV, hd]
    priv_v: Optional[torch.Tensor] = None,
    priv_src: Optional[torch.Tensor] = None,   # [B, S]
    priv_mask: Optional[torch.Tensor] = None,  # [S] bool
    priv_hist: Optional[PagedHistory] = None,  # paged dual of priv_k/priv_v
    check_layer: int = 1,
    pooled_selection: bool = False,
    block_select: int = 0,
    shard=noshard,
) -> PICResult:
    """CacheBlend-style recovery for a group of requests (module doc).
    Selection is per request, computed in one batched pass.
    ``block_select`` > 0 selects whole token blocks (EPIC-style), so
    Mirror diffs stay block-sparse; otherwise single tokens.
    ``pooled_selection`` (beyond the paper, off by default) selects ONE
    set for the whole group from the mean of the requests' scores, which
    aligns every mirror's diff blocks with the master's at the cost of
    per-request PIC equivalence."""
    with sharded(params):
        assert priv_k is None or priv_hist is None, \
            "pass dense priv_k/priv_v OR a PagedHistory, not both"
        B, S = tokens.shape
        L = cfg.n_layers
        theta = cfg.rope_theta
        dev = tokens.device
        tgt_pos = torch.arange(S, dtype=torch.int32, device=dev)
        is_cached = (shared_mask if priv_mask is None
                     else (shared_mask | priv_mask))

        # ---- 1. alignment: ONE rotation of the shared blocks for the group --
        aligned_k = align_cached_keys(shared_k, shared_src, tgt_pos, theta)
        if priv_hist is not None:
            base_layer = _paged_base_layer(priv_hist, aligned_k, shared_v, B,
                                           theta)
        else:
            KV, hd = shared_k.shape[2:]
            al_priv = pm = None
            if priv_k is not None:
                # private caches: per-request rotation, one launch
                al_priv = align_cached_keys(priv_k, priv_src[:, None],
                                            tgt_pos[None, None], theta)
                pm = priv_mask[None, :, None, None]

            def base_layer(l):
                k_l = aligned_k[l].expand(B, S, KV, hd).clone()
                v_l = shared_v[l].expand(B, S, KV, hd).clone()
                if al_priv is not None:
                    k_l = torch.where(pm, al_priv[:, l], k_l)
                    v_l = torch.where(pm, priv_v[:, l], v_l)
                return k_l, v_l

        # ---- 2. fresh pass over the first check_layer+1 layers --------------
        h = lookup(params["embed"], tokens).to(shared_k.dtype)
        positions = tgt_pos.expand(B, S).contiguous()
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, theta)
        fresh_k, fresh_v = [], []
        for l in range(check_layer + 1):
            h, outs = block_full(h, layer(params, l), cfg, window=S,
                                 positions=positions, cos=cos, sin=sin,
                                 shard=shard)
            fresh_k.append(outs["k"])
            fresh_v.append(outs["v"])

        # ---- 3. importance selection on the check layer ---------------------
        base_chk_k, _ = base_layer(check_layer)
        dk = fresh_k[check_layer].float() - base_chk_k.float()
        deviation = (dk * dk).sum(dim=(-1, -2))                   # [B, S]
        deviation = torch.where(is_cached[None], deviation, 0.0)
        scores = torch.where(is_cached[None], deviation, BIG)  # fresh win
        scores[:, S - 1] += 2 * BIG                            # last token
        if pooled_selection:
            scores = scores.mean(dim=0, keepdim=True).expand(B, S)
        if block_select:
            sel_idx = _select_blocks(scores, n_sel, block_select)
        else:
            idx = torch.sort(scores, dim=-1, descending=True,
                             stable=True).indices[:, :n_sel]
            sel_idx = torch.sort(idx, dim=-1).values

        # ---- 4. selective recomputation through the remaining layers --------
        rec_ks, rec_vs = [], []
        gather = sel_idx[:, :, None, None].expand(-1, -1,
                                                  *fresh_k[0].shape[2:])
        for l in range(check_layer + 1):
            bk_l, bv_l = base_layer(l)
            rec_ks.append(_scatter_rows(bk_l, fresh_k[l].gather(1, gather),
                                        sel_idx))
            rec_vs.append(_scatter_rows(bv_l, fresh_v[l].gather(1, gather),
                                        sel_idx))

        sel_pos = positions.gather(1, sel_idx).contiguous()      # [B, n_sel]
        cos_sel, sin_sel = rope_cos_sin(sel_pos, cfg.resolved_head_dim, theta)
        h_sel = h.gather(1, sel_idx[:, :, None].expand(-1, -1, h.shape[-1]))
        for l in range(check_layer + 1, L):
            bk_l, bv_l = base_layer(l)
            h_sel, k_m, v_m = _selective_block(
                h_sel, layer(params, l), cfg, sel_pos=sel_pos, cos_sel=cos_sel,
                sin_sel=sin_sel, k_base=bk_l, v_base=bv_l, sel_idx=sel_idx,
                shard=shard)
            rec_ks.append(k_m)
            rec_vs.append(v_m)

        # ---- 5. last-token logits -------------------------------------------
        row = (sel_idx == S - 1).int().argmax(dim=1)
        h_last = h_sel[torch.arange(B, device=dev), row][:, None]
        logits = logits_of(params, cfg, h_last, shard)[:, 0]
        return PICResult(torch.stack(rec_ks), torch.stack(rec_vs), deviation,
                         sel_idx, logits, h_sel)


def n_sel_for(layout_fresh: int, n_cached: int, ratio: float) -> int:
    """Selected-set size for token selection: every fresh position plus
    ``ratio`` of the cached ones (at least one)."""
    return layout_fresh + max(1, int(math.ceil(ratio * n_cached)))


def n_sel_for_blocks(fresh_mask, bt: int, ratio: float) -> int:
    """Selected-set size for block-granular selection: the blocks holding
    any fresh token (always selected) plus ``ratio`` of the pure-cached
    blocks, in tokens."""
    fm = np.asarray(fresh_mask, bool).copy()
    S = fm.shape[0]
    fm = np.pad(fm, (0, (-S) % bt))
    # block containing the last token is always selected (logits)
    fm[S - 1] = True
    blocks = fm.reshape(-1, bt).any(axis=1)
    n_fresh_blocks = int(blocks.sum())
    n_cached_blocks = int(blocks.size - n_fresh_blocks)
    nb_sel = n_fresh_blocks + max(1, math.ceil(ratio * n_cached_blocks))
    return min(nb_sel, blocks.size) * bt
