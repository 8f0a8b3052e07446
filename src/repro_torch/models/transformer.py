"""Decoder model of the port: weights, prefill and paged decode.

Parameters are the JAX package's pytree as nested dicts of tensors, with
every leaf under ``params["blocks"]`` stacked on a leading layer axis
(``[L, ...]``, as ``repro.core.pic._layer`` indexes it). Layers run as a
Python loop in eager mode. Public API:

  init_params(cfg, seed, device=None)       -> params (random, seeded)
  from_jax(params_np, cfg, device=None)     -> params (the JAX weights)
  prefill(params, cfg, tokens, ...)         -> logits, cache
  decode_step_paged(params, cfg, token, cache) -> logits, cache

``device=None`` means the CUDA device, and raises when there is none.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope,
    attention,
    check_supported,
    out_proj,
    project_qkv,
    rmsnorm,
    rope_cos_sin,
    swiglu_mlp,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int, device=None) -> dict:
    """Random weights from ``seed`` (an explicit ``torch.Generator`` on
    the target device), with the JAX ``init_params`` shapes and scales:
    N(0, 0.02) matrices, ``0.02/sqrt(2L)`` output projections, zero norms
    and biases. Each layer's slice is drawn in f32 and cast, so the f32
    scratch never exceeds one layer of one weight."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    L, D = cfg.n_layers, cfg.d_model
    hd, H, KV, F_ = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                     cfg.d_ff)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def w(shape, scale=0.02, stacked=True):
        out = torch.empty(shape, dtype=dt, device=dev)
        for sl in (out if stacked else [out]):
            sl.copy_(torch.randn(sl.shape, generator=gen, device=dev,
                                 dtype=torch.float32) * scale)
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    out_scale = 0.02 / math.sqrt(2 * L)
    attn = {"wq": w((L, D, H * hd)), "wk": w((L, D, KV * hd)),
            "wv": w((L, D, KV * hd)), "wo": w((L, H * hd, D), out_scale)}
    if cfg.attn_bias:
        attn.update(bq=zeros((L, H * hd)), bk=zeros((L, KV * hd)),
                    bv=zeros((L, KV * hd)))
    blocks = {
        "ln1": zeros((L, D)),
        "attn": attn,
        "mlp": {"w_gate": w((L, D, F_)), "w_up": w((L, D, F_)),
                "w_down": w((L, F_, D), out_scale)},
        "ln2": zeros((L, D)),
    }
    return {"embed": w((cfg.vocab_size, D), stacked=False), "blocks": blocks,
            "final_norm": zeros((D,)),
            "lm_head": w((D, cfg.vocab_size), stacked=False)}


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX ``init_params`` pytree (leaves as numpy arrays) as the
    port's parameters — same nesting, layer-stacked leaves unchanged."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _to_torch(tree, dev)

    return conv(params_np)


def layer(params: dict, l: int) -> dict:
    """Layer ``l``'s parameters (views into the stacked leaves)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[l]
    return pick(params["blocks"])


# --------------------------------------------------------------------------
# forward pieces
# --------------------------------------------------------------------------
def block_full(h: torch.Tensor, p: dict, cfg: ModelConfig, *,
               positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """One full-sequence layer (prefill, and PIC's fresh layers): causal
    attention over the sequence itself. Returns (h, k, v) with the layer's
    RoPE'd keys and values ``[B, S, KV, hd]``."""
    x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
    q, k, v = project_qkv(x, p["attn"], cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    h = h + out_proj(attention(q, k, v, q_pos=positions), p["attn"])
    h = h + swiglu_mlp(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps), p["mlp"])
    return h, k, v


def logits_of(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    return (h @ params["lm_head"].to(h.dtype)).float()


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, logits_last_only: bool = False):
    """Run the prompt ``[B, S]``; returns (logits, cache) with cache
    ``{"length": [B], "k"/"v": [L, B, max_len, KV, hd]}`` (zero past S).
    ``logits_last_only`` computes the last position's logits only."""
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    h = params["embed"][tokens].to(dtype_of(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S).contiguous()
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        h, k, v = block_full(h, layer(params, l), cfg, positions=positions,
                             cos=cos, sin=sin)
        ks.append(k)
        vs.append(v)
    logits = logits_of(params, cfg, h[:, -1:] if logits_last_only else h)
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = {"length": torch.full((B,), S, dtype=torch.int32,
                                  device=tokens.device),
             "k": torch.nn.functional.pad(torch.stack(ks), pad),
             "v": torch.nn.functional.pad(torch.stack(vs), pad)}
    return logits, cache


def decode_step_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict):
    """One greedy-decode step whose KV lives in page pools.

    ``cache``: ``pk``/``pv`` ``[L, P, bt, KV, hd]``, ``page_idx`` int32
    ``[B, nbt]`` (sequence b's pages in order) and ``length`` int32 ``[B]``
    (tokens already cached; they are valid from position 0 — the serving
    engine's layout). The new token's K/V is written into page
    ``page_idx[b, length // bt]`` at slot ``length % bt``, IN PLACE in the
    pools (the decode state owns them); attention then reads the first
    ``length + 1`` tokens of each sequence's pages through the paged
    decode kernel. Returns (logits ``[B, V]``, cache with ``length + 1``).
    """
    check_supported(cfg)
    B = token.shape[0]
    h = params["embed"][token][:, None].to(dtype_of(cfg))
    length = cache["length"]
    positions = length[:, None]
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    page_idx = cache["page_idx"]
    pk, pv = cache["pk"], cache["pv"]
    bt = pk.shape[2]
    rows = torch.arange(B, device=token.device)
    pages = page_idx[rows, (length // bt).long()].long()
    slots = (length % bt).long()
    span = length + 1
    for l in range(cfg.n_layers):
        p = layer(params, l)
        x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
        q, k, v = project_qkv(x, p["attn"], cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        pk[l][pages, slots] = k[:, 0]
        pv[l][pages, slots] = v[:, 0]
        o = ops.flash_decode_paged(q[:, 0].contiguous(), pk[l], pv[l],
                                   page_idx, span)
        h = h + out_proj(o[:, None], p["attn"])
        h = h + swiglu_mlp(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps), p["mlp"])
    logits = logits_of(params, cfg, h)[:, 0]
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return logits, new_cache
