"""Plain PyTorch versions of the four Hopper kernels' functions.

Each function here is the reference its kernel is held against on the
card (``chip_smoke.py``, ``tests/test_torch_kernels.py``) and the path
:mod:`repro_torch.kernels.ops` takes for a tensor that lies on the CPU.
They repeat the JAX package's oracles (``repro/kernels/ref.py``) in the
port's layouts: batched over a leading axis where the serving path
launches one kernel for many rows, and with per-sequence lengths on
device where the engine keeps them there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """f32 ``1/θ^(i/half)`` for ``i < head_dim/2`` — the frequency form
    ``models.layers.rope_cos_sin`` rotates with."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_delta_ref(k: torch.Tensor, delta: torch.Tensor,
                   theta: float) -> torch.Tensor:
    """Rotate keys ``[A..., S, KV, hd]`` by per-token position deltas.

    ``delta`` is int ``[S]`` (shared by every leading row) or ``[D, S]``
    with ``D`` dividing the product ``A`` of the leading dims: leading row
    ``a`` (flattened) uses ``delta[a // (A // D)]``.
    """
    S, KV, hd = k.shape[-3:]
    half = hd // 2
    A = k[..., 0, 0, 0].numel()
    d = delta.reshape(-1, S)
    D = d.shape[0]
    assert A % D == 0, (A, D)
    ang = d.float()[:, None, :, None] * rope_freqs(hd, theta, k.device)
    cos = torch.cos(ang)[..., None, :]                # [D, 1, S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    kf = k.float().reshape(D, A // D, S, KV, hd)
    k1, k2 = kf[..., :half], kf[..., half:]
    out = torch.cat([k1 * cos - k2 * sin, k2 * cos + k1 * sin], dim=-1)
    return out.reshape(k.shape).to(k.dtype)


def rope_align_ref(k: torch.Tensor, src_pos: torch.Tensor,
                   tgt_pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Re-rotate keys ``[..., S, KV, hd]`` from ``src_pos`` to ``tgt_pos``."""
    return rope_delta_ref(k, tgt_pos - src_pos, theta)


def block_diff_ref(ks: torch.Tensor, vs: torch.Tensor, master: int,
                   bt: int) -> torch.Tensor:
    """Per-block max |x - x[master]| over layers, tokens, heads and both
    planes: ``ks``/``vs`` ``[N, L, S, KV, hd]`` -> f32 ``[N, ceil(S/bt)]``.
    A ragged last block is zero-padded (a padded row differs nowhere)."""
    N, L, S, KV, hd = ks.shape
    nb = -(-S // bt)
    pad = nb * bt - S

    def one(x):
        x = x.float()
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        d = (x - x[master]).abs().reshape(N, L, nb, bt, KV, hd)
        return d.amax(dim=(1, 3, 4, 5))

    return torch.maximum(one(ks), one(vs))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_pos: torch.Tensor, window: int,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention of queries at arbitrary positions over a dense KV.

    q ``[B, Sq, H, hd]``; k/v ``[B, Sk, KV, hd]``; ``q_pos`` int ``[B, Sq]``.
    Column ``j`` (its position is ``j``) is allowed for a query at ``p``
    iff ``0 <= p - j < window`` and ``j < kv_len[b]``. Masked logits are
    ``-2^30``; softmax in f32. Returns ``[B, Sq, H, hd]`` in v's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    cols = torch.arange(Sk, device=q.device)
    delta = q_pos[:, :, None].long() - cols[None, None, :]       # [B, Sq, Sk]
    allowed = (delta >= 0) & (delta < window)
    if kv_len is not None:
        allowed = allowed & (cols[None, None, :] < kv_len[:, None, None])
    logits = torch.where(allowed[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def flash_decode_paged_ref(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, page_idx: torch.Tensor,
                           span_len: torch.Tensor,
                           tail_k: Optional[torch.Tensor] = None,
                           tail_v: Optional[torch.Tensor] = None,
                           tail_len: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One query per sequence over its page-table KV, then a dense tail.

    q ``[B, H, hd]``; pools ``[P, bt, KV, hd]``; ``page_idx`` int
    ``[B, nbt]``; ``span_len`` int ``[B]`` (tokens valid from the pages);
    tails ``[B, Tp, KV, hd]`` with the first ``tail_len`` rows valid. The
    query sits after everything valid, so the only mask is validity.
    Gathers the dense stream the kernel never builds, then attends.
    """
    B, H, hd = q.shape
    P, bt, KV, _ = pool_k.shape
    nbt = page_idx.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = page_idx.long()
    k = pool_k[idx].reshape(B, nbt * bt, KV, hd)
    v = pool_v[idx].reshape(B, nbt * bt, KV, hd)
    cols = torch.arange(nbt * bt, device=q.device)
    valid = cols[None, :] < span_len[:, None]
    if tail_k is not None and tail_len:
        Tp = tail_k.shape[1]
        k = torch.cat([k, tail_k], dim=1)
        v = torch.cat([v, tail_v], dim=1)
        tvalid = torch.arange(Tp, device=q.device) < tail_len
        valid = torch.cat([valid, tvalid[None].expand(B, Tp)], dim=1)
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * scale
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(v.dtype)
