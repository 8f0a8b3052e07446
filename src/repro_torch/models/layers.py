"""Core layers in PyTorch: RMSNorm, RoPE, GQA attention and SwiGLU MLP.

Plain functions on tensors with parameters in nested dicts, as in
``repro.models.layers``, with the JAX package's layouts at every public
function (activations ``[B, S, ...]``, heads ``[B, S, H, hd]``). All
attention goes through :func:`attention`, which launches the port's
flash-attention kernel on a CUDA tensor (``kernels.ops``). The features
of the served configurations are ported — dense attention with sliding
windows and per-head q/k RMSNorm (``qk_norm``), tied embeddings
(``models.transformer.logits_of``), and SSM / hybrid layers
(``models.ssm``); :func:`check_supported` raises for the rest.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rope_freqs


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for architecture features the port
    does not implement yet (MoE, logit softcap, non-text frontends)."""
    missing = [name for name, on in (
        ("MoE", cfg.is_moe),
        ("logit softcap", bool(cfg.attn_logit_softcap)),
        ("frontend", cfg.frontend != "none"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


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
              q_pos: torch.Tensor, window: int) -> torch.Tensor:
    """GQA attention of queries at ``q_pos`` ([B, Sq] int32) over KV whose
    column j sits at position j: the JAX ``gqa_attention`` with ``kv_pos =
    arange(Sk)`` — column j is allowed iff ``0 <= q_pos - j < window``.
    q ``[B, Sq, H, hd]``, k/v ``[B, Sk, KV, hd]``."""
    return ops.flash_attention(q, k, v, q_pos=q_pos, window=window)


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
