"""Plain PyTorch versions of the Hopper kernels' functions.

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


def cap_logits(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    """``c * tanh(logits / c)`` for a ``softcap`` c > 0 (Grok's logit soft
    cap, applied as ``repro.models.layers.gqa_attention`` applies it: to
    the scaled f32 logits, before the mask); the logits as they are for
    c = 0."""
    return softcap * torch.tanh(logits / softcap) if softcap else logits


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


def fused_diff_restore_ref(master_k, master_v, diff_k, diff_v, diff_slot,
                           slot_map, delta_pos, theta: float, pool_k,
                           pool_v):
    """Algorithm 1 for one mirror: block select + RoPE recovery + paged
    write, IN PLACE into the pools (returned).

    master ``[L, nb, bt, KV, hd]``; diffs ``[L, ndb, bt, KV, hd]``;
    ``diff_slot`` int ``[nb]`` (row into the diffs, -1 = Master block);
    ``slot_map`` int ``[nb]`` destination pages; ``delta_pos`` int
    ``[nb, bt]``; pools ``[L, P, bt, KV, hd]``.
    """
    L, nb, bt, KV, hd = master_k.shape
    have = (diff_slot >= 0)[None, :, None, None, None]
    rows = diff_slot.clamp(min=0).long()
    k = torch.where(have, diff_k[:, rows], master_k)
    v = torch.where(have, diff_v[:, rows], master_v)
    k = rope_delta_ref(k.reshape(L, nb * bt, KV, hd),
                       delta_pos.reshape(nb * bt), theta)
    pages = slot_map.long()
    pool_k[:, pages] = k.reshape(L, nb, bt, KV, hd)
    pool_v[:, pages] = v
    return pool_k, pool_v


def fused_family_restore_ref(master_k, master_v, diff_k, diff_v, diff_slot,
                             slot_map, delta_pos, theta: float, pool_k,
                             pool_v):
    """Algorithm 1 for a whole family (ONE Master, M mirrors), IN PLACE
    into the pools (returned).

    master ``[L, nb, bt, KV, hd]``; diffs ``[M, L, ndb, bt, KV, hd]``;
    ``diff_slot``/``slot_map`` int ``[M, nb]`` (maps disjoint across
    mirrors); ``delta_pos`` int ``[M, nb, bt]``; pools ``[L, P, bt, KV,
    hd]``.
    """
    L, nb, bt, KV, hd = master_k.shape
    M = diff_slot.shape[0]
    have = (diff_slot >= 0)[:, None, :, None, None, None]
    rows = diff_slot.clamp(min=0).long()
    dk = torch.stack([diff_k[m][:, rows[m]] for m in range(M)])
    dv = torch.stack([diff_v[m][:, rows[m]] for m in range(M)])
    k = torch.where(have, dk, master_k[None])              # [M, L, nb, ...]
    v = torch.where(have, dv, master_v[None])
    k = rope_delta_ref(k.reshape(M, L, nb * bt, KV, hd),
                       delta_pos.reshape(M, nb * bt), theta)
    pages = slot_map.reshape(M * nb).long()
    pool_k[:, pages] = k.reshape(M, L, nb, bt, KV, hd).transpose(0, 1) \
        .reshape(L, M * nb, bt, KV, hd)
    pool_v[:, pages] = v.transpose(0, 1).reshape(L, M * nb, bt, KV, hd)
    return pool_k, pool_v


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
                        scale: Optional[float] = None,
                        causal: bool = True,
                        softcap: float = 0.0) -> torch.Tensor:
    """GQA attention of queries at arbitrary positions over a dense KV.

    q ``[B, Sq, H, hd]``; k/v ``[B, Sk, KV, hd]``; ``q_pos`` int ``[B, Sq]``.
    Column ``j`` (its position is ``j``) is allowed for a query at ``p``
    iff ``0 <= p - j < window`` and ``j < kv_len[b]`` (``causal=False``
    drops the ``0 <=``). A ``softcap`` c > 0 caps the scaled logits to
    ``c * tanh(s / c)`` (:func:`cap_logits`) before the mask. Masked
    logits are ``-2^30``; softmax in f32.
    Returns ``[B, Sq, H, hd]`` in v's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    logits = cap_logits(
        torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale, softcap)
    cols = torch.arange(Sk, device=q.device)
    delta = q_pos[:, :, None].long() - cols[None, None, :]       # [B, Sq, Sk]
    allowed = delta < window
    if causal:
        allowed = allowed & (delta >= 0)
    if kv_len is not None:
        allowed = allowed & (cols[None, None, :] < kv_len[:, None, None])
    logits = torch.where(allowed[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, *, q_pos: torch.Tensor,
                            window: int,
                            kv_len: Optional[torch.Tensor] = None,
                            softcap: float = 0.0):
    """Gradients of :func:`flash_attention_ref` (causal, default scale)
    with respect to q, k and v, by the closed-form softmax backward in
    f32 — no autograd: the backward kernel's plain version.

    ``out`` is the forward's result and ``dout`` its gradient, both ``[B,
    Sq, H, hd]``. With the scaled logits ``r = q k^T / sqrt(hd)``, ``s =
    c tanh(r / c)`` under a soft cap c > 0 (else ``s = r``), masked as the
    forward masks them, ``P = softmax(s)`` and ``D = rowsum(dout * out)``:
    ``dV = P^T dout``, ``dS = P (dout v^T - D)``, ``dR = dS (1 - tanh^2(r
    / c))`` (``dS`` without a cap), ``dQ = dR k / sqrt(hd)`` and ``dK =
    dR^T q / sqrt(hd)``; dK and dV sum over the G query heads of each KV
    head. A masked pair contributes nothing; a row with no allowed
    column gets no gradient. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    dog = dout.reshape(B, Sq, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    cols = torch.arange(Sk, device=q.device)
    delta = q_pos[:, :, None].long() - cols[None, None, :]       # [B, Sq, Sk]
    allowed = (delta >= 0) & (delta < window)
    if kv_len is not None:
        allowed = allowed & (cols[None, None, :] < kv_len[:, None, None])
    allowed = allowed[:, None, None]
    logits = torch.where(allowed, cap_logits(raw, softcap),
                         torch.tensor(NEG_INF, device=q.device))
    # masked pairs contribute nothing, also in a row with no allowed
    # column (whose forward output, uniform over every column, is undefined)
    probs = torch.where(allowed, torch.softmax(logits, dim=-1), 0.0)
    dlt = (dog * out.reshape(B, Sq, KV, G, hd).float()).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = probs * (dp - dlt.permute(0, 2, 3, 1)[..., None])
    if softcap:
        ds = ds * (1.0 - torch.tanh(raw / softcap).square())
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", probs, dog)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_kv_ref(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 page_idx: torch.Tensor, tail_k: Optional[torch.Tensor],
                 tail_v: Optional[torch.Tensor], span_len: int):
    """The dense KV stream of paged sequences: gather ``page_idx`` (int
    ``[B, nbh]``) out of the pools (``[P, bt, KV, hd]``), keep the first
    ``span_len`` rows, append the dense tails (``[B, T, KV, hd]`` or None).
    Returns k, v ``[B, span_len + T, KV, hd]`` — exactly the
    materialisation the paged kernel avoids."""
    B, nbh = page_idx.shape
    P, bt, KV, hd = pool_k.shape
    idx = page_idx.long()
    k = pool_k[idx].reshape(B, nbh * bt, KV, hd)[:, :span_len]
    v = pool_v[idx].reshape(B, nbh * bt, KV, hd)[:, :span_len]
    if tail_k is not None and tail_k.shape[1]:
        k = torch.cat([k, tail_k], dim=1)
        v = torch.cat([v, tail_v], dim=1)
    return k, v


def flash_attention_paged_ref(q: torch.Tensor, pool_k: torch.Tensor,
                              pool_v: torch.Tensor, page_idx: torch.Tensor,
                              tail_k: Optional[torch.Tensor],
                              tail_v: Optional[torch.Tensor], *,
                              span_len: int, causal: bool = True,
                              window: int = 0,
                              q_pos: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              softcap: float = 0.0) -> torch.Tensor:
    """Flash prefill over paged KV: gather pages + tails
    (:func:`paged_kv_ref`), then dense attention. q ``[B, Sq, H, hd]``,
    queries at ``q_pos`` (int ``[B, Sq]``; default row i at position i,
    with Sq == span_len + T as the JAX oracle requires); ``window`` 0 is
    unbounded, as in the JAX kernel; ``softcap`` as in
    :func:`flash_attention_ref`."""
    k, v = paged_kv_ref(pool_k, pool_v, page_idx, tail_k, tail_v, span_len)
    B, Sq = q.shape[:2]
    if q_pos is None:
        assert Sq == k.shape[1], (Sq, k.shape[1])
        q_pos = torch.arange(Sq, dtype=torch.int32,
                             device=q.device).expand(B, Sq)
    return flash_attention_ref(q, k, v, q_pos=q_pos,
                               window=window if window else 2 ** 31 - 1,
                               scale=scale, causal=causal, softcap=softcap)


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   allowed: torch.Tensor, scale: float,
                   softcap: float = 0.0) -> torch.Tensor:
    """One query per sequence (q ``[B, H, hd]``) over dense k/v
    ``[B, Sk, KV, hd]`` where ``allowed`` ``[B, Sk]``; the scaled logits
    capped by a ``softcap`` c > 0 (:func:`cap_logits`); softmax in f32.
    The one body of both decode references, so the dense and the paged
    plain versions compute the same bits on the same rows."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = cap_logits(
        torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * scale, softcap)
    logits = torch.where(allowed[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(v.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, window: int,
                     scale: Optional[float] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """One query per sequence over its dense KV, with a sliding window.

    q ``[B, H, hd]``; k/v ``[B, Sk, KV, hd]``; ``kv_len`` int ``[B]``.
    Sequence b's query sits at position ``kv_len[b] - 1``: column ``j`` is
    allowed iff ``j < kv_len[b]`` and ``kv_len[b] - 1 - j < window``.
    ``softcap`` as in :func:`flash_attention_ref`. Masked logits are
    ``-2^30``; softmax in f32. Returns ``[B, H, hd]``
    in v's dtype (the JAX ``flash_decode_ref`` with a batch axis).
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cols = torch.arange(k.shape[1], device=q.device)
    kl = kv_len.long()[:, None]
    allowed = (cols[None, :] < kl) & (kl - 1 - cols[None, :] < window)
    return _decode_attend(q, k, v, allowed, scale, softcap)


def flash_decode_paged_ref(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, page_idx: torch.Tensor,
                           span_len: torch.Tensor,
                           tail_k: Optional[torch.Tensor] = None,
                           tail_v: Optional[torch.Tensor] = None,
                           tail_len: int = 0, window: int = 0,
                           scale: Optional[float] = None,
                           softcap: float = 0.0) -> torch.Tensor:
    """One query per sequence over its page-table KV, then a dense tail.

    q ``[B, H, hd]``; pools ``[P, bt, KV, hd]``; ``page_idx`` int
    ``[B, nbt]``; ``span_len`` int ``[B]`` (tokens valid from the pages);
    tails ``[B, Tp, KV, hd]`` with the first ``tail_len`` rows valid. Page
    column c sits at position c and tail row t at ``span_len[b] + t``; the
    query sits after everything valid, at ``qpos = span_len[b] + tail_len
    - 1``. A valid column at position c is allowed iff ``qpos - c <
    window`` (``window`` 0: unbounded, as in the JAX kernel); ``softcap``
    as in :func:`flash_attention_ref`. Gathers the dense stream the kernel
    never builds, then attends.
    """
    B, H, hd = q.shape
    P, bt, KV, _ = pool_k.shape
    nbt = page_idx.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = page_idx.long()
    k = pool_k[idx].reshape(B, nbt * bt, KV, hd)
    v = pool_v[idx].reshape(B, nbt * bt, KV, hd)
    span = span_len.long()[:, None]
    pos = torch.arange(nbt * bt, device=q.device)[None, :].expand(B, -1)
    valid = pos < span
    tl = tail_len if tail_k is not None else 0
    if tl:
        Tp = tail_k.shape[1]
        k = torch.cat([k, tail_k], dim=1)
        v = torch.cat([v, tail_v], dim=1)
        rows = torch.arange(Tp, device=q.device)[None, :]
        valid = torch.cat([valid, (rows < tl).expand(B, Tp)], dim=1)
        pos = torch.cat([pos, span + rows], dim=1)
    if window:
        valid = valid & (span + tl - 1 - pos < window)
    return _decode_attend(q, k, v, valid, scale, softcap)


def mixed_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of f32 activations ``[..., K]`` and a bf16 weight ``[K,
    N]`` in f32: the weight widened (exactly) and one f32 product."""
    return x @ w.float()


def split_bf16x3(x: torch.Tensor):
    """The mixed-precision kernel's split of f32 ``x`` into three bf16
    parts, by truncation: x0 the upper 16 bits of x, x1 those of x - x0,
    x2 = x - x0 - x1 (both subtractions exact in f32, x2 exact in bf16).
    ``x0 + x1 + x2 == x`` for every x that is a multiple of 2^-133 (bf16's
    least subnormal; every |x| >= 2^-110); below that the parts lose what
    lies under it. For inf and NaN, x1 = x2 = 0."""
    def upper(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    x0 = upper(x)
    r1 = torch.where(torch.isfinite(x), x - x0, torch.zeros_like(x))
    x1 = upper(r1)
    x2 = upper(r1 - x1)
    return x0.bfloat16(), x1.bfloat16(), x2.bfloat16()
