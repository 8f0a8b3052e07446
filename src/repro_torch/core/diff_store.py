"""Diff-Aware Storage — Master-Mirror layout with block-sparse diffs
(paper §4.3, Fig. 8), in PyTorch.

After collective reuse, the N recovered caches of a round differ only at
the privately-recomputed positions. Storage keeps ONE dense Master cache
and encodes every sibling as a Mirror: the indices of the 32-token blocks
that differ plus the K/V values of exactly those blocks (K and V share the
block-index list). Which blocks differ is decided by ONE ``block_diff``
launch for the whole family and both planes (``kernels.ops``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

BLOCK_TOKENS = 32


def _pad_to_blocks(x: torch.Tensor, bt: int) -> torch.Tensor:
    """Zero-pad the token axis (axis 1 of [L, S, KV, hd]) to a block
    multiple (no copy when already aligned)."""
    pad = (-x.shape[1]) % bt
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class MasterCache:
    """The one dense cache kept per round group."""

    rid: str
    k: torch.Tensor         # [L, S, KV, hd]
    v: torch.Tensor
    positions: np.ndarray   # int32 [S] absolute positions of entries

    def nbytes(self) -> int:
        return 2 * _nbytes(self.k)


@dataclass
class MirrorDiff:
    """Block-sparse correction of one sibling cache against its Master."""

    rid: str
    master_rid: str
    block_idx: np.ndarray    # int32 [nb] touched 32-token blocks (shared K/V)
    k_vals: torch.Tensor     # [L, nb, bt, KV, hd]
    v_vals: torch.Tensor     # [L, nb, bt, KV, hd]
    old_pos: np.ndarray      # master frame positions  [S]
    new_pos: np.ndarray      # mirror frame positions  [S]
    seq_len: int
    block_tokens: int = BLOCK_TOKENS

    @property
    def n_blocks(self) -> int:
        return int(self.block_idx.shape[0])

    @property
    def total_blocks(self) -> int:
        return -(-self.seq_len // self.block_tokens)

    def nbytes(self) -> int:
        data = 2 * _nbytes(self.k_vals)
        meta = self.block_idx.nbytes + self.old_pos.nbytes + self.new_pos.nbytes
        return data + meta


@dataclass
class MirrorHandle:
    """Lazy read object: Master reference + sparse diff metadata. The dense
    Mirror tensor is never materialized at rest (paper §4.3 'On read')."""

    master: MasterCache
    diff: MirrorDiff

    def nbytes(self) -> int:      # storage cost attributable to this mirror
        return self.diff.nbytes()


def block_diff_mask(
    master_k: torch.Tensor, master_v: torch.Tensor,     # [L, S, KV, hd]
    mirror_k: torch.Tensor, mirror_v: torch.Tensor,
    *,
    block_tokens: int = BLOCK_TOKENS,
    tol: float = 0.0,
) -> torch.Tensor:
    """Bool ``[n_blocks]`` on the inputs' device: True where any position
    of the block differs by more than ``tol`` (union over layers and the
    K/V planes). One ``block_diff`` launch over the pair stacked as a
    family of two with the Master first, in the widest of the four
    dtypes (the difference JAX takes is in the promoted type)."""
    dt = master_k.dtype
    for t in (master_v, mirror_k, mirror_v):
        dt = torch.promote_types(dt, t.dtype)
    ks = torch.stack([master_k.to(dt), mirror_k.to(dt)])
    vs = torch.stack([master_v.to(dt), mirror_v.to(dt)])
    return ops.block_diff(ks, vs, 0, block_tokens)[1] > tol


def build_mirror(
    rid: str,
    master: MasterCache,
    mirror_k: torch.Tensor,
    mirror_v: torch.Tensor,
    new_pos: np.ndarray,
    *,
    block_tokens: int = BLOCK_TOKENS,
    tol: float = 0.0,
) -> MirrorDiff:
    """Encode one sibling cache as a block-sparse diff against the Master.
    The frames must agree (``new_pos`` equal to the Master's positions):
    JAX raises ``ValueError`` otherwise, and so does this. The diff's
    value rows are copies, not views of ``mirror_k``/``mirror_v``."""
    old_pos = np.asarray(master.positions, np.int32)
    new_pos = np.asarray(new_pos, np.int32)
    if not np.array_equal(old_pos, new_pos):
        raise ValueError("build_mirror requires aligned frames (new_pos "
                         "equal to the Master's positions)")
    mask = block_diff_mask(master.k, master.v, mirror_k, mirror_v,
                           block_tokens=block_tokens, tol=tol)
    idx = np.flatnonzero(mask.cpu().numpy()).astype(np.int32)
    xk = _pad_to_blocks(mirror_k, block_tokens)
    xv = _pad_to_blocks(mirror_v, block_tokens)
    L, Sp, KV, hd = xk.shape
    nb = Sp // block_tokens
    sel = torch.as_tensor(idx, dtype=torch.long, device=xk.device)
    return MirrorDiff(
        rid=rid, master_rid=master.rid, block_idx=idx,
        k_vals=xk.reshape(L, nb, block_tokens, KV, hd)[:, sel],
        v_vals=xv.reshape(L, nb, block_tokens, KV, hd)[:, sel],
        old_pos=old_pos, new_pos=new_pos,
        seq_len=int(mirror_k.shape[1]), block_tokens=block_tokens)


def build_round_family(
    request_ids: Sequence[str],
    ks: torch.Tensor,          # [N, L, S, KV, hd] recovered caches
    vs: torch.Tensor,
    positions: np.ndarray,     # [S] shared target positions (compatible group)
    master_idx: int,
    *,
    block_tokens: int = BLOCK_TOKENS,
    tol: float = 0.0,
) -> Tuple[MasterCache, List[MirrorHandle]]:
    """Compress a round group's caches into Master + Mirrors.

    The master index comes from the reuse plan (lowest total deviation).
    The changed-block masks of ALL mirrors and both planes come from one
    ``block_diff`` launch; only the [N, nb] mask crosses to the host. The
    Master and every diff's value rows are copies, so the family holds no
    view of ``ks``/``vs``.
    """
    ks, vs = ks.contiguous(), vs.contiguous()
    master = MasterCache(
        rid=request_ids[master_idx], k=ks[master_idx].clone(),
        v=vs[master_idx].clone(), positions=np.asarray(positions, np.int32))
    N, L, S, KV, hd = ks.shape
    bt = block_tokens
    masks = (ops.block_diff(ks, vs, master_idx, bt) > tol).cpu().numpy()
    nb = masks.shape[1]

    def blockify(a):
        a = F.pad(a, (0, 0, 0, 0, 0, nb * bt - S)) if nb * bt != S else a
        return a.reshape(N, L, nb, bt, KV, hd)

    kb, vb = blockify(ks), blockify(vs)
    handles = []
    for i, rid in enumerate(request_ids):
        if i == master_idx:
            continue
        idx = np.flatnonzero(masks[i]).astype(np.int32)
        sel = torch.as_tensor(idx, dtype=torch.long, device=ks.device)
        diff = MirrorDiff(
            rid=rid, master_rid=master.rid, block_idx=idx,
            k_vals=kb[i][:, sel], v_vals=vb[i][:, sel],
            old_pos=master.positions, new_pos=master.positions,
            seq_len=S, block_tokens=bt)
        handles.append(MirrorHandle(master, diff))
    return master, handles


def trim_family(handles: Sequence[MirrorHandle],
                seq_len: int, *, start: int = 0) -> List[MirrorHandle]:
    """Restrict a Master family to the token span ``[start, seq_len)``.

    Restore then covers only the blocks a consumer reads: the trimmed
    Master keeps ``ceil(seq_len / bt)`` blocks and each mirror only the
    diff blocks inside them. A non-zero ``start`` (block-aligned) trims to
    a delta span with block indices re-based. Within the kept span the
    restored values equal restoring the full family and slicing.
    """
    assert handles, "empty family"
    master = handles[0].master
    bt = handles[0].diff.block_tokens
    full = handles[0].diff.seq_len
    assert 0 <= start < seq_len <= full, (start, seq_len, full)
    assert start % bt == 0, \
        (start, bt, "delta trim must start on a block boundary")
    for h in handles:
        assert h.master is master or h.diff.master_rid == master.rid, \
            "trim_family needs one shared Master"
        assert h.diff.block_tokens == bt and h.diff.seq_len == full, \
            "family mirrors must share block size and length"
    if seq_len == full and start == 0:
        return list(handles)
    b0 = start // bt
    nbh = -(-seq_len // bt)
    tm = MasterCache(
        rid=master.rid, k=master.k[:, start:seq_len],
        v=master.v[:, start:seq_len],
        positions=np.asarray(master.positions[start:seq_len], np.int32))
    out = []
    for h in handles:
        d = h.diff
        bidx = np.asarray(d.block_idx)
        keep = np.flatnonzero((bidx >= b0) & (bidx < nbh))
        sel = torch.as_tensor(keep, dtype=torch.long, device=d.k_vals.device)
        out.append(MirrorHandle(tm, MirrorDiff(
            rid=d.rid, master_rid=d.master_rid,
            block_idx=(bidx[keep] - b0).astype(np.int32),
            k_vals=d.k_vals[:, sel], v_vals=d.v_vals[:, sel],
            old_pos=np.asarray(d.old_pos[start:seq_len], np.int32),
            new_pos=np.asarray(d.new_pos[start:seq_len], np.int32),
            seq_len=seq_len - start, block_tokens=bt)))
    return out


@dataclass
class FamilyPack:
    """Stacked per-family diff tensors (ragged per-mirror diff counts
    padded with zero rows to the family max ``ndb``; ``diff_slot`` maps
    only the real rows, -1 elsewhere)."""

    rids: List[str]             # mirror request ids, row order
    diff_k: torch.Tensor        # [M, L, ndb, bt, KV, hd]
    diff_v: torch.Tensor
    diff_slot: np.ndarray       # int32 [M, nb]: row into diff_*[m] or -1
    delta_pos: np.ndarray       # int32 [M, nb, bt] RoPE recovery deltas
    nb: int                     # blocks per mirror (padded seq / bt)
    block_tokens: int
    seq_len: int

    @property
    def n_mirrors(self) -> int:
        return len(self.rids)

    def nbytes(self) -> int:
        data = 2 * _nbytes(self.diff_k)
        return data + self.diff_slot.nbytes + self.delta_pos.nbytes


def pack_family(handles: Sequence[MirrorHandle]) -> FamilyPack:
    """Stack a Master family's mirror diffs into per-family tensors. All
    handles share one Master and block size; values are zero-padded to
    the largest diff count (min 1)."""
    assert handles, "empty family"
    master = handles[0].master
    bt = handles[0].diff.block_tokens
    S = handles[0].diff.seq_len
    for h in handles:
        assert h.master is master or h.diff.master_rid == master.rid, \
            "pack_family needs one shared Master"
        assert h.diff.block_tokens == bt and h.diff.seq_len == S, \
            "family mirrors must share block size and length"
    nb = -(-S // bt)
    Sp = nb * bt
    ndb = max(1, max(h.diff.n_blocks for h in handles))
    M = len(handles)

    slot = np.full((M, nb), -1, np.int32)
    dpos = np.zeros((M, Sp), np.int32)
    ks, vs = [], []
    for m, h in enumerate(handles):
        d = h.diff
        slot[m, np.asarray(d.block_idx)] = np.arange(d.n_blocks)
        delta = np.asarray(d.new_pos, np.int64) - np.asarray(d.old_pos,
                                                             np.int64)
        dpos[m, : delta.shape[0]] = delta.astype(np.int32)
        pad = (0, 0, 0, 0, 0, 0, 0, ndb - d.n_blocks)
        ks.append(F.pad(d.k_vals, pad))
        vs.append(F.pad(d.v_vals, pad))
    return FamilyPack(
        rids=[h.diff.rid for h in handles],
        diff_k=torch.stack(ks), diff_v=torch.stack(vs),
        diff_slot=slot, delta_pos=dpos.reshape(M, nb, bt),
        nb=nb, block_tokens=bt, seq_len=S)


def similarity_master(token_lists: Sequence[np.ndarray]) -> int:
    """Fallback Master choice when no reuse plan exists (paper §5): the
    entry with the highest summed pairwise token overlap (Jaccard over
    the token sets); ties go to the first, as ``np.argmax`` gives them."""
    n = len(token_lists)
    if n == 1:
        return 0
    sets = [set(map(int, t)) for t in token_lists]
    scores = []
    for i in range(n):
        s = 0.0
        for j in range(n):
            if i == j:
                continue
            inter = len(sets[i] & sets[j])
            union = len(sets[i] | sets[j]) or 1
            s += inter / union
        scores.append(s)
    return int(np.argmax(scores))


def compression_stats(master: MasterCache,
                      handles: Sequence[MirrorHandle]) -> dict:
    dense_one = master.nbytes()
    n = 1 + len(handles)
    dense_total = dense_one * n
    stored = dense_one + sum(h.nbytes() for h in handles)
    changed = [h.diff.n_blocks for h in handles]
    return {
        "n_caches": n,
        "dense_bytes": dense_total,
        "stored_bytes": stored,
        "compression_ratio": dense_total / stored,
        "per_mirror_ratio": (dense_one / (sum(h.nbytes() for h in handles) / max(1, len(handles))))
        if handles else float("inf"),
        "avg_changed_blocks": float(np.mean(changed)) if changed else 0.0,
        "total_blocks": handles[0].diff.total_blocks if handles else 0,
    }
