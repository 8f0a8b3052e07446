"""Frozen operation and byte counts: the bound of an attention call and
the model FLOPs of a served round. Peaks of one H100 SXM (NVIDIA's data
sheet, dense): 989 TFLOP/s for bf16 operands; for f32 operands the
port's split-TF32 products, 495 / 3 TFLOP/s; 3.35 TB/s of HBM."""
from __future__ import annotations

import math

import torch

HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK = {2: PEAK_BF16, 4: 495e12 / 3}


def bound_s(n_bytes: float, flops: float, elsize: int) -> float:
    return max(n_bytes / HBM_BYTES_S, flops / PEAK[elsize])


def attention_pairs(q_pos: torch.Tensor, window: int, Sk: int,
                    kv_len=None) -> int:
    """Allowed (query, key) pairs: key j for a query at p iff
    ``0 <= p - j < window`` and ``j < min(Sk, kv_len[b])``."""
    p = q_pos.long()
    lim = torch.full((p.shape[0],), Sk, device=p.device, dtype=torch.long)
    if kv_len is not None:
        lim = torch.minimum(lim, kv_len.long())
    hi = torch.minimum(p, lim[:, None] - 1)
    lo = torch.clamp(p - window + 1, min=0)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_attention_bound(q_shape, k_shape, elsize: int, pairs: int,
                          has_kv_len: bool) -> float:
    """q ``[B, Sq, H, hd]``, k = v ``[B, Sk, KV, hd]``: every operand
    byte read once, the output written once; 4 H hd FLOPs a pair."""
    B, Sq, H, hd = q_shape
    n_bytes = (elsize * (2 * math.prod(q_shape) + 2 * math.prod(k_shape))
               + 4 * B * Sq + (4 * B if has_kv_len else 0))
    return bound_s(n_bytes, 4 * H * hd * pairs, elsize)


def decode_paged_bound(q_shape, kv_heads: int, elsize: int, rows: int,
                       page_idx_numel: int) -> float:
    """q ``[B, H, hd]`` over ``rows`` cached rows in all (the span rows,
    not whole pages): K and V of each read once."""
    B, H, hd = q_shape
    n_bytes = (elsize * (2 * B * H * hd + 2 * rows * kv_heads * hd)
               + 4 * page_idx_numel + 4 * B)
    return bound_s(n_bytes, 4 * H * hd * rows, elsize)


def layer_flops_per_token(s: dict) -> int:
    """2 x the non-embedding parameters a token meets in one layer."""
    D, H, KV, hd, F = s["D"], s["H"], s["KV"], s["hd"], s["F"]
    return 2 * (D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F)


def attn_flops(s: dict, n_pairs: int) -> int:
    return 4 * s["H"] * s["hd"] * n_pairs


def batch_flops(s: dict, N: int, S: int, G: int, sel=None,
                check_layer: int = 1) -> int:
    """Model FLOPs of one batch of a round: its recovery and its decode.

    ``sel`` (rounds >= 1): the recomputed positions ``[N, n_sel]``. Every
    prompt token goes through layers ``0..check_layer``, the selected
    rows through the rest; without ``sel`` (round 0) every token through
    every layer. Then ``G - 1`` decode tokens an agent, each over the
    prompt and the tokens before it, and one logits row per token."""
    L, lin = s["L"], layer_flops_per_token(s)
    head = 2 * s["D"] * s["V"]
    causal = S * (S + 1) // 2
    if sel is None:
        rec = N * (L * S * lin + L * attn_flops(s, causal))
    else:
        c = min(check_layer, L - 1)
        n_sel = len(sel[0])
        pairs = sum(int(p) + 1 for row in sel for p in row)
        rec = (N * (c + 1) * (S * lin + attn_flops(s, causal))
               + (L - c - 1) * (N * n_sel * lin + attn_flops(s, pairs)))
    dec_pairs = sum(S + t + 1 for t in range(G - 1))
    dec = N * ((G - 1) * L * lin + L * attn_flops(s, dec_pairs))
    return rec + dec + N * G * head
