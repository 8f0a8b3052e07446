"""Core layers in PyTorch: RMSNorm, RoPE, GQA attention, SwiGLU MLP and
capacity-dispatched MoE.

Plain functions on tensors with parameters in nested dicts, as in
``repro.models.layers``, with the JAX package's layouts at every public
function (activations ``[B, S, ...]``, heads ``[B, S, H, hd]``). The
full-sequence attention goes through :func:`attention`, which launches
the port's flash-attention kernel on a CUDA tensor (``kernels.ops``),
with the config's logit soft cap. Every feature of the JAX package's
configurations is ported: sliding windows, per-head q/k RMSNorm
(``qk_norm``), the logit soft cap, top-k MoE with a dense residual
(:func:`moe_block`), tied embeddings and the stubbed frontends
(``models.transformer``), and SSM / hybrid layers (``models.ssm``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rope_freqs


# --------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype jnp's promotion gives the JAX package's
    einsum: a bf16 weight meets f32 activations in collective recovery
    (the cached KV is f32), and is cast at use, never stored twice. No
    copy when the dtypes agree."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """f32 (cos, sin) ``[..., head_dim/2]`` for integer positions."""
    ang = positions.float()[..., None] * rope_freqs(head_dim, theta,
                                                     positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[..., S, H, hd]`` by cos/sin ``[..., S, hd/2]``
    (split-halves convention)."""
    dt = x.dtype
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def rope_shift(k: torch.Tensor, old_pos: torch.Tensor, new_pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Re-rotate keys ``[..., S, H, hd]`` from ``old_pos`` to ``new_pos``
    (rotation by the delta composes with the original one)."""
    cos, sin = rope_cos_sin(new_pos - old_pos, k.shape[-1], theta)
    return apply_rope(k, cos, sin)


# --------------------------------------------------------------------------
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, window: int,
              softcap: float = 0.0) -> torch.Tensor:
    """GQA attention of queries at ``q_pos`` ([B, Sq] int32) over KV whose
    column j sits at position j: the JAX ``gqa_attention`` with ``kv_pos =
    arange(Sk)`` — column j is allowed iff ``0 <= q_pos - j < window``,
    and a ``softcap`` c > 0 caps the scaled logits to ``c * tanh(s / c)``.
    q ``[B, Sq, H, hd]``, k/v ``[B, Sk, KV, hd]``."""
    return ops.flash_attention(q, k, v, q_pos=q_pos, window=window,
                               softcap=softcap)


def project_qkv(x: torch.Tensor, p: dict, cfg):
    """q ``[B, S, H, hd]`` and k/v ``[B, S, KV, hd]``: bias added, then
    with ``cfg.qk_norm`` each head of q and k RMS-normed (``q_norm`` /
    ``k_norm`` ``[hd]``), as JAX does it at every attention site; no
    RoPE. Every attention of the port projects here, so cached keys are
    stored normed."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def proj(w, b, nh):
        y = matmul(x, p[w]).view(B, S, nh, hd)
        return y + p[b].view(nh, hd) if b in p else y

    q, k = proj("wq", "bq", H), proj("wk", "bk", KV)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    return q, k, proj("wv", "bv", KV)


def out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    """``[B, S, H, hd]`` attention output -> ``[B, S, D]``."""
    B, S = o.shape[:2]
    return matmul(o.reshape(B, S, -1), p["wo"])


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    return matmul(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def moe_route(xg: torch.Tensor, router: torch.Tensor, K: int):
    """The router of :func:`moe_block` on token groups ``xg`` ``[G, tg,
    D]``: (f32 probabilities ``[G, tg, E]``, the top ``K`` weights
    renormalised, their expert indices ``[G, tg, K]``). Ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them (a zero pad row
    has uniform probabilities): a stable descending sort, first K."""
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = top.values[..., :K], top.indices[..., :K]
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def moe_block(x: torch.Tensor, p: dict, cfg, group_size: int = 1024):
    """Top-k MoE with capacity-based dispatch, JAX's ``moe_block``: returns
    (out ``[B, S, D]``, the f32 load-balance loss ``E * sum(me * ce)``).

    The ``B * S`` tokens, flattened in row-major order and zero-padded to
    whole groups of ``tg = min(group_size, B * S)``, are routed per group
    (:func:`moe_route`: f32 softmax, the top ``K`` experts, their weights
    renormalised). Each expert takes ``C = max(8, ceil(tg * K / E
    * capacity_factor))`` tokens a group, slotted in token order; the
    overflow is dropped (the dense residual, Arctic's, still sees it).
    Each expert's SwiGLU runs on its own ``[G, C, D]`` rows with its own
    weight slice, cast at use (never the whole ``[E, D, F]`` tensor);
    experts no token reached are skipped, as their rows are zeros that
    no token reads back. ``me`` averages the router probabilities over
    every row of the groups, the pad rows included, as JAX does."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * S, D)
    T = xf.shape[0]
    tg = min(group_size, T)
    pad = (-T) % tg
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, D))])
    G = xf.shape[0] // tg
    xg = xf.view(G, tg, D)

    probs, topw, topi = moe_route(xg, p["router"], K)

    # capacity and slots: a token's rank among the group's tokens that
    # chose the same expert, in token order
    C = max(8, int(math.ceil(tg * K / E * cfg.capacity_factor)))
    tok_expert = F.one_hot(topi, E).sum(dim=2)                 # [G, tg, E]
    pos_in_expert = tok_expert.cumsum(dim=1) - tok_expert
    pos_choice = pos_in_expert.gather(2, topi)                 # [G, tg, K]
    flat_slot = torch.where(pos_choice < C, topi * C + pos_choice, E * C)

    # dispatch: each slot's token row (tg: a zero row; E * C: dropped)
    slot_token = torch.full((G, E * C + 1), tg, dtype=torch.long,
                            device=x.device)
    token_ids = torch.arange(tg, device=x.device)[None, :, None]
    slot_token.scatter_(1, flat_slot.reshape(G, -1),
                        token_ids.expand(G, tg, K).reshape(G, -1))
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    x_disp = x_pad.gather(1, slot_token[:, :E * C, None].expand(-1, -1, D))
    x_disp = x_disp.view(G, E, C, D)

    # experts, one weight slice at a time
    dt = torch.promote_types(x.dtype, p["w_down"].dtype)
    y_disp = torch.zeros((G, E, C, D), dtype=dt, device=x.device)
    for e in torch.unique(flat_slot[flat_slot < E * C] // C).tolist():
        xe = x_disp[:, e]
        h = F.silu(matmul(xe, p["w_gate"][e])) * matmul(xe, p["w_up"][e])
        y_disp[:, e] = matmul(h, p["w_down"][e])

    # combine: each token's kept slots, weighted and summed
    y_flat = torch.cat([y_disp.view(G, E * C, D),
                        y_disp.new_zeros((G, 1, D))], dim=1)
    y_choice = y_flat.gather(
        1, flat_slot.reshape(G, -1, 1).expand(-1, -1, D)).view(G, tg, K, D)
    y = (y_choice * topw[..., None].to(dt)).sum(dim=2)
    out = y.reshape(-1, D)[:T].reshape(B, S, D)
    if cfg.dense_residual:
        out = out + swiglu_mlp(x, p["dense"])
    me = probs.reshape(-1, E).mean(dim=0)
    ce = tok_expert.reshape(-1, E).float().mean(dim=0)
    return out, E * (me * ce).sum()


def feed_forward(h: torch.Tensor, p: dict, cfg):
    """A layer's second half on the residual stream ``h``: ``h`` plus the
    MoE block or the SwiGLU MLP of ``rmsnorm(h, ln2)``, or ``h`` as it is
    where the layer has neither (an SSM layer). Returns (h, the layer's
    MoE load-balance loss, or None without MoE)."""
    if cfg.is_moe:
        out, aux = moe_block(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps), p["moe"],
                             cfg)
        return h + out, aux
    if "mlp" in p:
        return h + swiglu_mlp(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps),
                              p["mlp"]), None
    return h, None
