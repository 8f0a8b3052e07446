"""Decoder model of the port: weights, prefill and decode.

One block function handles attention, SSM and hybrid layers (attention
and Mamba2 heads side by side, each output RMS-normed, then averaged),
each followed by a SwiGLU MLP, an MoE block (with Arctic's dense
residual) or, in an attention-free SSM layer, nothing.
Parameters are the JAX package's pytree as nested dicts of tensors, with
every leaf under ``params["blocks"]`` stacked on a leading layer axis
(``[L, ...]``, as ``repro.core.pic._layer`` indexes it). Layers run as a
Python loop in eager mode. Public API:

  init_params(cfg, seed, device=None)       -> params (random, seeded)
  from_jax(params_np, cfg, device=None)     -> params (the JAX weights)
  forward(params, cfg, tokens, ...)         -> logits, aux (scoring and
                                               training; differentiable)
  prefill(params, cfg, tokens, ...)         -> logits, cache
  make_empty_cache(cfg, batch, max_len, ...) -> cache
  extend(params, cfg, tokens, cache)        -> logits, cache (chunked prefill)
  decode_step(params, cfg, token, cache)    -> logits, cache (dense KV)
  decode_step_paged(params, cfg, token, cache) -> logits, cache (pages)

``device=None`` means the CUDA device, and raises when there is none.
``long_context=True`` (every entry point that attends) gives every layer
the config's ``long_context_window``, as JAX's ``_windows`` does. The
config's ``attn_logit_softcap`` reaches every attention call (Grok-1).
A ``frontend`` (audio, vision) is stubbed as in JAX: ``forward`` and
``prefill`` take precomputed ``frontend_embeds`` for the first positions;
the other entry points read tokens.

``forward``, ``prefill`` and ``decode_step`` take JAX's ``shard`` hook
(``models.layers.noshard`` by default, which changes nothing). With
DTensor parameters (``launch.sharding.distribute_params``) and
``shard=rules.shard`` they run sharded over the rules' mesh; plain
tensors (tokens, positions, RoPE tables) then take part as replicated
(``implicit_replication``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_rope,
    attention,
    feed_forward,
    lookup,
    matmul,
    noshard,
    out_proj,
    project_qkv,
    rmsnorm,
    rope_cos_sin,
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
    and biases. Each matrix (a layer's, or a layer's expert's) is drawn
    in f32 and cast, so the f32 scratch never exceeds one matrix."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    L, D = cfg.n_layers, cfg.d_model
    hd, H, KV, F_ = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                     cfg.d_ff)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def w(shape, scale=0.02, stacked=True):
        out = torch.empty(shape, dtype=dt, device=dev)
        for sl in (out.view(-1, *shape[-2:]) if stacked else [out]):
            sl.copy_(torch.randn(sl.shape, generator=gen, device=dev,
                                 dtype=torch.float32) * scale)
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32)

    out_scale = 0.02 / math.sqrt(2 * L)
    blocks = {"ln1": zeros((L, D))}
    if cfg.has_attention:
        attn = {"wq": w((L, D, H * hd)), "wk": w((L, D, KV * hd)),
                "wv": w((L, D, KV * hd)), "wo": w((L, H * hd, D), out_scale)}
        if cfg.attn_bias:
            attn.update(bq=zeros((L, H * hd)), bk=zeros((L, KV * hd)),
                        bv=zeros((L, KV * hd)))
        if cfg.qk_norm:
            attn.update(q_norm=zeros((L, hd)), k_norm=zeros((L, hd)))
        blocks["attn"] = attn
    if cfg.has_ssm:
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        dt_init = torch.exp(uniform((L, nh)) * (math.log(0.1)
                                                 - math.log(0.001))
                            + math.log(0.001))
        blocks["ssm"] = {
            "in_proj": w((L, D, 2 * di + 2 * n + nh)),
            "conv_w": w((L, ssm_mod.D_CONV, di + 2 * n), 0.2),
            # dt_bias and A_log stay f32 whatever the model dtype
            "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
            "A_log": torch.log(1.0 + 15.0 * uniform((L, nh))),
            "D_skip": torch.ones((L, nh), dtype=dt, device=dev),
            "out_norm": zeros((L, di)),
            "out_proj": w((L, di, D), out_scale),
        }
    if cfg.hybrid:
        blocks["attn_out_norm"] = zeros((L, D))
        blocks["ssm_out_norm"] = zeros((L, D))
    if cfg.is_moe:
        E = cfg.n_experts
        moe = {"router": w((L, D, E)), "w_gate": w((L, E, D, F_)),
               "w_up": w((L, E, D, F_)), "w_down": w((L, E, F_, D), out_scale)}
        if cfg.dense_residual:
            moe["dense"] = {"w_gate": w((L, D, F_)), "w_up": w((L, D, F_)),
                            "w_down": w((L, F_, D), out_scale)}
        blocks["moe"] = moe
        blocks["ln2"] = zeros((L, D))
    elif cfg.d_ff and cfg.arch_type != "ssm":
        blocks["mlp"] = {"w_gate": w((L, D, F_)), "w_up": w((L, D, F_)),
                         "w_down": w((L, F_, D), out_scale)}
        blocks["ln2"] = zeros((L, D))
    params = {"embed": w((cfg.vocab_size, D), stacked=False),
              "blocks": blocks, "final_norm": zeros((D,))}
    if not cfg.tie_embeddings:      # tied: the logits read embed.T
        params["lm_head"] = w((D, cfg.vocab_size), stacked=False)
    return params


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX ``init_params`` pytree (leaves as numpy arrays) as the
    port's parameters — same nesting, every leaf (``q_norm``/``k_norm``
    included), layer-stacked leaves unchanged, each in its own dtype (the
    SSM's ``dt_bias``/``A_log`` stay f32)."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _to_torch(tree, dev)

    return conv(params_np)


def _pick(tree, l: int):
    if isinstance(tree, dict):
        return {k: _pick(v, l) for k, v in tree.items()}
    return tree[l]


def layer(params: dict, l: int) -> dict:
    """Layer ``l``'s parameters (views into the stacked leaves)."""
    # a module-level walk: a recursive closure here would make a reference
    # cycle (function <-> cell) on every call, garbage for the collector
    return _pick(params["blocks"], l)


def _unbind(tree, n: int) -> list:
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][l] for k in per} for l in range(n)]
    return list(torch.unbind(tree))


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def layer_list(params: dict, n_layers: int) -> list:
    """Every layer's parameters, in order. Where autograd records (grad
    enabled and a stacked leaf requires grad) each ``[L, ...]`` leaf is
    taken apart ONCE with ``torch.unbind``, whose backward stacks the
    layers' gradients in one allocation; indexing it per layer instead
    (:func:`layer`) would make every layer's backward add a zero tensor
    the size of the whole stack. Otherwise the views of :func:`layer`."""
    blocks = params["blocks"]
    if torch.is_grad_enabled() and _requires_grad(blocks):
        return _unbind(blocks, n_layers)
    return [layer(params, l) for l in range(n_layers)]


# --------------------------------------------------------------------------
# forward pieces
# --------------------------------------------------------------------------
def _windows(cfg: ModelConfig, max_len: int, long_context: bool = False):
    """Per-layer attention window for a cache of ``max_len`` rows (a
    window of ``max_len`` or more is full causal attention);
    ``long_context`` gives every layer ``cfg.long_context_window`` where
    the config has one."""
    if long_context and cfg.long_context_window:
        return [min(cfg.long_context_window, max_len)] * cfg.n_layers
    return list(cfg.layer_window_sizes(max_len)) or [max_len] * cfg.n_layers


@contextlib.contextmanager
def sharded(params: dict):
    """The context an entry point runs in: ``implicit_replication`` where
    the parameters are DTensors, so plain tensors mix with them as
    replicated; nothing otherwise. Nests: ``implicit_replication`` sets
    one process-wide flag and clears it on exit, so an inner entry point
    (``forward`` inside a training step, whose backward also mixes) leaves
    the flag to the outermost one."""
    if (not isinstance(params["final_norm"], DTensor)
            or DTensor._op_dispatcher._allow_implicit_replication):
        yield
        return
    with implicit_replication():
        yield


def block_full(h: torch.Tensor, p: dict, cfg: ModelConfig, *, window: int,
               positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               shard=noshard):
    """One full-sequence layer (prefill, and PIC's fresh layers): causal
    attention over the sequence itself within ``window``, and/or the
    Mamba2 mixer, then the MLP or MoE. Returns (h, outs) with the layer's
    RoPE'd keys and values ``outs["k"]``/``outs["v"]`` ``[B, S, KV, hd]``,
    its SSM and conv states ``outs["ssm"]``/``outs["conv"]`` and, with
    MoE, its load-balance loss ``outs["aux"]``."""
    outs = {}
    x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
    mixer = None
    if cfg.has_attention:
        q, k, v = project_qkv(x, p["attn"], cfg, shard)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        outs["k"], outs["v"] = k, v
        mixer = shard(out_proj(attention(
            q, k, v, q_pos=positions, window=window,
            softcap=cfg.attn_logit_softcap), p["attn"]), "act_resid")
        if cfg.hybrid:
            mixer = rmsnorm(mixer, p["attn_out_norm"], cfg.rmsnorm_eps)
    if cfg.has_ssm:
        s_out, (outs["ssm"], outs["conv"]) = ssm_mod.mixer(
            ssm_mod.mamba2_forward, x, p["ssm"], cfg=cfg)
        mixer = _mix(mixer, s_out, p, cfg)
    h, aux = feed_forward(h + mixer, p, cfg, shard)
    if aux is not None:
        outs["aux"] = aux
    return shard(h, "act_resid"), outs


def _mix(a_out, s_out, p: dict, cfg: ModelConfig):
    """The SSM output, or for a hybrid layer the mean of the two RMS-normed
    mixer outputs."""
    if not cfg.hybrid:
        return s_out
    return 0.5 * (a_out + rmsnorm(s_out, p["ssm_out_norm"], cfg.rmsnorm_eps))


def logits_of(params: dict, cfg: ModelConfig, h: torch.Tensor,
              shard=noshard) -> torch.Tensor:
    """f32 logits of the hidden state: the final norm, then ``lm_head``, or
    ``embed.T`` with ``cfg.tie_embeddings`` (JAX's ``_logits``), by
    ``layers.matmul``; tagged ``logits``."""
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard(matmul(h, table).float(), "logits")


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings ``[B, S, D]`` in the model dtype; ``frontend_embeds``
    ``[B, Sf, D]`` replaces the first Sf positions (JAX's ``_embed``)."""
    h = lookup(params["embed"], tokens).to(dtype_of(cfg))
    if frontend_embeds is not None:
        sf = frontend_embeds.shape[1]
        h = torch.cat([frontend_embeds.to(h.dtype), h[:, sf:]], dim=1)
    return h


def _run_full(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
              windows, frontend_embeds, keep: bool, remat: bool = False,
              shard=noshard):
    """Every layer over the whole sequence (``block_full``): the final
    hidden state ``[B, S, D]`` (before the final norm), with ``keep`` each
    layer's cache outputs, and the layers' MoE losses summed (a 0-d f32;
    zero without MoE). The one layer loop of :func:`forward` and
    :func:`prefill`, so the two give the same bits. ``remat`` runs each
    layer under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept."""
    B, S = tokens.shape
    h = shard(_embed(params, cfg, tokens, frontend_embeds), "act_resid")
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S).contiguous()
    cos = sin = None
    if cfg.has_attention:
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim,
                                cfg.rope_theta)
    per_layer = []
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l, p in enumerate(layer_list(params, cfg.n_layers)):
        if remat:
            h, outs = torch.utils.checkpoint.checkpoint(
                block_full, h, p, cfg, window=windows[l],
                positions=positions, cos=cos, sin=sin, shard=shard,
                use_reentrant=False)
        else:
            h, outs = block_full(h, p, cfg, window=windows[l],
                                 positions=positions, cos=cos, sin=sin,
                                 shard=shard)
        if "aux" in outs:
            aux = aux + outs.pop("aux")
        if keep:
            per_layer.append(outs)
    return h, per_layer, aux


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend_embeds: Optional[torch.Tensor] = None,
            shard=noshard, remat: bool = False, long_context: bool = False,
            return_hidden: bool = False):
    """Training / scoring pass over ``tokens`` ``[B, S]``: (logits f32
    ``[B, S, V]``, aux), or with ``return_hidden`` (the hidden state
    ``[B, S, D]`` before the final norm, aux). ``aux`` is the MoE
    load-balance loss summed over layers as JAX sums it, a 0-d f32 (zero
    for a model without MoE). ``frontend_embeds`` ``[B, Sf, D]`` replace
    the first Sf positions' token embeddings (the stubbed audio / vision
    frontend).

    Windows are the layers' at S (JAX's). The layer loop is
    :func:`prefill`'s, so on the same weights and tokens the logits equal
    ``prefill(..., max_len=S)``'s bit for bit. Differentiable: attention
    runs through ``ops.flash_attention``'s autograd function (the backward
    kernel on the card), and stacked leaves that require grad are taken
    apart once (:func:`layer_list`). ``remat=True`` (JAX's keyword; its
    ``loss_fn`` passes True) checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): the same loss and
    gradients, bit for bit, for one more forward a layer.
    ``shard`` is JAX's hook (module doc): with DTensor parameters and
    ``launch.sharding.ShardingRules.shard`` the pass runs sharded, each
    attention call on local shards. JAX's ``unroll`` (a ``lax.scan``
    knob; eager layers need none) is not accepted.
    """
    S = tokens.shape[1]
    with sharded(params):
        h, _, aux = _run_full(params, cfg, tokens,
                              _windows(cfg, S, long_context),
                              frontend_embeds, keep=False, remat=remat,
                              shard=shard)
        if return_hidden:
            return h, aux
        return logits_of(params, cfg, h, shard), aux


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            shard=noshard, long_context: bool = False,
            logits_last_only: bool = False):
    """Run the prompt ``[B, S]``; returns (logits, cache) with cache
    ``{"length": [B], "k"/"v": [L, B, max_len, KV, hd]}`` (zero past S)
    for attention, plus ``"ssm"`` ``[L, B, nh, hp, n]`` (f32) and
    ``"conv"`` ``[L, B, D_CONV-1, conv_dim]`` for SSM layers. Attention
    windows are the layers' windows at ``max_len``, as the JAX ``prefill``
    takes them. ``logits_last_only`` computes the last position's logits
    only. ``frontend_embeds`` and ``shard`` as in :func:`forward`."""
    B, S = tokens.shape
    max_len = max_len or S
    with sharded(params):
        h, per_layer, _ = _run_full(params, cfg, tokens,
                                    _windows(cfg, max_len, long_context),
                                    frontend_embeds, keep=True, shard=shard)
        logits = logits_of(params, cfg,
                           h[:, -1:] if logits_last_only else h, shard)
        cache = {"length": torch.full((B,), S, dtype=torch.int32,
                                      device=tokens.device)}
        if cfg.has_attention:
            pad = (0, 0, 0, 0, 0, max_len - S)
            for key in ("k", "v"):
                cache[key] = shard(torch.nn.functional.pad(
                    torch.stack([o[key] for o in per_layer]), pad),
                    "cache_kv")
        if cfg.has_ssm:
            for key in ("ssm", "conv"):
                cache[key] = torch.stack([o[key] for o in per_layer])
    return logits, cache


def make_empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                     device=None) -> dict:
    """An all-empty dense decode cache (``length`` 0)."""
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg)
    L = cfg.n_layers
    cache = {"length": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.has_attention:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cache["k"] = torch.zeros((L, batch, max_len, KV, hd), dtype=dt,
                                 device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    if cfg.has_ssm:
        cache["ssm"] = torch.zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
            dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (L, batch, ssm_mod.D_CONV - 1, cfg.d_inner + 2 * cfg.ssm_state),
            dtype=dt, device=dev)
    return cache


def extend(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           cache: dict, *, long_context: bool = False):
    """Extend a dense cache by T known tokens in one pass (chunked
    prefill: the prefix-cache policy's suffix compute).

    ``tokens`` ``[B, T]``; ``cache``: ``length`` int32 ``[B]`` (rows
    cached, valid from position 0) and ``k``/``v`` ``[L, B, max_len, KV,
    hd]`` as :func:`prefill` returns them. Token t of sequence b sits at
    position ``length[b] + t``; its RoPE'd K/V is written into that row,
    IN PLACE, in the cache's dtype (the caller owns the cache, as in
    :func:`decode_step`). Attention runs through the prefill kernel with
    ``q_pos`` at those positions and ``kv_len = length + T``, so rows past
    the new tokens are never read. Attention caches only: an SSM or hybrid
    model raises ``ValueError``. Returns (logits ``[B, T, V]``, cache with
    ``length + T``).
    """
    if cfg.has_ssm or not cfg.has_attention:
        raise ValueError("extend() supports attention caches; use "
                         "prefill/decode for SSM state")
    B, T = tokens.shape
    h = params["embed"][tokens].to(dtype_of(cfg))
    length = cache["length"]
    positions = length[:, None] + torch.arange(
        T, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    windows = _windows(cfg, kc.shape[2], long_context)
    rows = torch.arange(B, device=tokens.device)[:, None]
    at = positions.long()
    kv_len = length + T
    for l in range(cfg.n_layers):
        p = layer(params, l)
        x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
        q, k, v = project_qkv(x, p["attn"], cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc[l][rows, at] = k.to(kc.dtype)
        vc[l][rows, at] = v.to(vc.dtype)
        o = ops.flash_attention(
            q.to(torch.promote_types(q.dtype, kc.dtype)).contiguous(),
            kc[l], vc[l], q_pos=positions, window=windows[l], kv_len=kv_len,
            softcap=cfg.attn_logit_softcap)
        h, _ = feed_forward(h + out_proj(o, p["attn"]), p, cfg)
    new_cache = dict(cache)
    new_cache["length"] = kv_len
    return logits_of(params, cfg, h), new_cache


def _write_row(c: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
               at: torch.Tensor) -> None:
    """``c[rows[b], at[b]] = new[b]`` for a layer's cache ``c`` ``[B, S,
    KV, hd]`` (``rows = arange(B)``), in place. A DTensor cache (batch and
    sequence may be split) takes an elementwise select over its local
    shards instead of the row scatter."""
    if not isinstance(c, DTensor):
        c[rows, at] = new
        return
    hit = torch.arange(c.shape[1], device=at.device) == at[:, None]
    c.copy_(torch.where(hit[:, :, None, None], new[:, None], c))


def _whole_heads(q: torch.Tensor) -> torch.Tensor:
    """A decode query ``[B, H, hd]``; as a DTensor, its heads gathered and
    any partial sum reduced, the batch left split: the plain version
    regroups the heads by KV head, which a head split cannot follow (48
    heads in 8 groups on a 16-way axis). Its split sequence (the cache's)
    DTensor reduces as the softmax needs."""
    if not isinstance(q, DTensor):
        return q
    return q.redistribute(placements=[
        pl if pl == Shard(0) else Replicate() for pl in q.placements])


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, *, shard=noshard, long_context: bool = False):
    """One greedy-decode step over a dense cache (the engine's dense loop:
    every SSM or hybrid model, and the oracle of the paged loop).

    ``cache``: ``length`` int32 ``[B]`` (tokens cached; valid from
    position 0), attention ``k``/``v`` ``[L, B, max_len, KV, hd]`` and SSM
    ``ssm``/``conv`` state as :func:`prefill` returns them. The new
    token's K/V is written into row ``length[b]``, IN PLACE (the caller
    owns the cache), in the cache's dtype — a cache wider than the model
    (f32 KV recovered for a bf16 model) promotes the residual stream from
    the first attention on, as in :func:`decode_step_paged`. Attention
    reads the first ``length + 1`` rows within each layer's window
    through the dense decode kernel; the SSM layers take one recurrent
    step. Returns (logits ``[B, V]``, cache with ``length + 1`` and the
    new SSM states). ``shard`` as in :func:`forward`; on DTensors the
    attention is the plain version's (the kernel takes no DTensor).
    """
    with sharded(params):
        B = token.shape[0]
        h = lookup(params["embed"], token)[:, None].to(dtype_of(cfg))
        length = cache["length"]
        new_cache = dict(cache)
        if cfg.has_attention:
            cos, sin = rope_cos_sin(length[:, None], cfg.resolved_head_dim,
                                    cfg.rope_theta)
            kc, vc = cache["k"], cache["v"]
            windows = _windows(cfg, kc.shape[2], long_context)
            rows = torch.arange(B, device=token.device)
            at = length.long()
            kv_len = length + 1
        states, convs = [], []
        for l in range(cfg.n_layers):
            p = layer(params, l)
            x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
            mixer = None
            if cfg.has_attention:
                q, k, v = project_qkv(x, p["attn"], cfg)
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
                _write_row(kc[l], k[:, 0].to(kc.dtype), rows, at)
                _write_row(vc[l], v[:, 0].to(vc.dtype), rows, at)
                o = ops.flash_decode(
                    _whole_heads(q[:, 0].to(torch.promote_types(
                        q.dtype, kc.dtype))).contiguous(),
                    kc[l], vc[l], kv_len, windows[l],
                    softcap=cfg.attn_logit_softcap)
                mixer = shard(out_proj(o[:, None], p["attn"]), "act_resid")
                if cfg.hybrid:
                    mixer = rmsnorm(mixer, p["attn_out_norm"],
                                    cfg.rmsnorm_eps)
            if cfg.has_ssm:
                s_out, (st, cv) = ssm_mod.mixer(
                    ssm_mod.mamba2_decode, x, p["ssm"], cfg=cfg,
                    state=cache["ssm"][l], conv_state=cache["conv"][l])
                states.append(st)
                convs.append(cv)
                mixer = _mix(mixer, s_out, p, cfg)
            h, _ = feed_forward(h + mixer, p, cfg, shard)
            h = shard(h, "act_resid")
        logits = logits_of(params, cfg, h, shard)[:, 0]
        if cfg.has_ssm:
            new_cache["ssm"] = torch.stack(states)
            new_cache["conv"] = torch.stack(convs)
        new_cache["length"] = length + 1
    return logits, new_cache


def decode_step_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict, *, long_context: bool = False):
    """One greedy-decode step whose KV lives in page pools.

    ``cache``: ``pk``/``pv`` ``[L, P, bt, KV, hd]``, ``page_idx`` int32
    ``[B, nbt]`` (sequence b's pages in order) and ``length`` int32 ``[B]``
    (tokens already cached; they are valid from position 0 — the serving
    engine's layout). Pools may be wider than the model dtype (f32 KV
    recovered for a bf16 model): the new K/V is stored in the pool's
    dtype and the residual stream promotes from the first attention on. The new token's K/V is written into page
    ``page_idx[b, length // bt]`` at slot ``length % bt``, IN PLACE in the
    pools (the decode state owns them); attention then reads the first
    ``length + 1`` tokens of each sequence's pages within each layer's
    window (the layers' own at the pages' length ``nbt * bt``, or
    ``long_context``'s, as JAX's ``_windows`` gives them) through the
    paged decode kernel. Returns (logits ``[B, V]``, cache with ``length
    + 1``).
    """
    if cfg.has_ssm or not cfg.has_attention:
        raise ValueError("paged decode carries attention KV only; use "
                         "decode_step for SSM state")
    windows = _windows(cfg, cache["page_idx"].shape[1] * cache["pk"].shape[2],
                       long_context)
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
        pk[l][pages, slots] = k[:, 0].to(pk.dtype)
        pv[l][pages, slots] = v[:, 0].to(pv.dtype)
        # attention runs in the pool's dtype where the query's is narrower
        # (a bf16 model over recovered f32 KV), as jnp promotion does
        o = ops.flash_decode_paged(
            q[:, 0].to(torch.promote_types(q.dtype, pk.dtype)).contiguous(),
            pk[l], pv[l], page_idx, span, window=windows[l],
            softcap=cfg.attn_logit_softcap)
        h, _ = feed_forward(h + out_proj(o[:, None], p["attn"]), p, cfg)
    logits = logits_of(params, cfg, h)[:, 0]
    new_cache = dict(cache)
    new_cache["length"] = length + 1
    return logits, new_cache
