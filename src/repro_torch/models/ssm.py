"""Mamba2 / SSD (state-space duality) layer in PyTorch [arXiv:2405.21060].

The chunked SSD algorithm for prefill and the O(1) recurrent update for
decode, as ``repro.models.ssm`` computes them (outside any kernel there,
plain tensor code here). Parameters follow the reference layout: in_proj
-> (z, x, B, C, dt), short causal depthwise conv over (x, B, C), A_log /
dt_bias / D per head, gated RMSNorm, out_proj. The SSM state, dt and A
are f32 whatever the model dtype; the conv state keeps the model dtype.
On DTensors the mixer runs on local shards (:func:`mixer`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import matmul, rmsnorm, widen

D_CONV = 4  # depthwise conv width
NEG_INF = -2.0 ** 30


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: ``out[..., i, j] = sum_{j < t <= i} x[..., t]``,
    ``NEG_INF`` above the diagonal (non-causal entries)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.tensor(NEG_INF, dtype=seg.dtype,
                                               device=x.device))


def ssd_chunked(
    x: torch.Tensor,        # [B, S, H, P]  (already multiplied by dt)
    dtA: torch.Tensor,      # [B, S, H]     (dt * A, negative)
    Bmat: torch.Tensor,     # [B, S, N]     (single group, shared by heads)
    Cmat: torch.Tensor,     # [B, S, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked SSD scan: (y ``[B, S, H, P]`` in x's dtype, final
    state ``[B, H, P, N]`` f32). The sequence is zero-padded to a multiple
    of ``chunk``; the inter-chunk recurrence is a loop over chunks."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk
    xc = x.reshape(B, nc, chunk, H, P).float()
    ac = dtA.reshape(B, nc, chunk, H).permute(0, 3, 1, 2).float()  # [B,H,nc,l]
    bc = Bmat.reshape(B, nc, chunk, N).float()
    cc = Cmat.reshape(B, nc, chunk, N).float()

    a_cum = torch.cumsum(ac, dim=-1)                           # [B,H,nc,l]

    # intra-chunk (diagonal blocks)
    Lm = torch.exp(_segsum(ac))                                # [B,H,nc,l,l]
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc, bc, Lm, xc)

    # per-chunk output states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # [B,H,nc,l]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(a_cum[..., -1])                    # [B,H,nc]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)                                         # entering c
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [B,nc,H,P,N]

    # contribution of the incoming state to each position of the chunk
    state_decay = torch.exp(a_cum)                             # [B,H,nc,l]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, h_in, state_decay)

    y = (y_diag + y_off).reshape(B, Sp, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_step(
    x: torch.Tensor,      # [B, H, P]  (already * dt)
    dtA: torch.Tensor,    # [B, H]
    Bmat: torch.Tensor,   # [B, N]
    Cmat: torch.Tensor,   # [B, N]
    state: torch.Tensor,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step: ``h' = exp(dtA) h + x B^T``, ``y = h' C``."""
    state = state.float()
    decay = torch.exp(dtA.float())[..., None, None]
    upd = x.float()[..., None] * Bmat.float()[:, None, None, :]
    new_state = state * decay + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cmat.float())
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# Mamba2 layer
# --------------------------------------------------------------------------
def causal_conv(u: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width ``D_CONV``: u ``[B, S, C]``, w
    ``[D_CONV, C]``. Returns (out ``[B, S, C]``, new state
    ``[B, D_CONV-1, C]``)."""
    B, S, Cd = u.shape
    if state is None:
        state = u.new_zeros((B, D_CONV - 1, Cd))
    full = torch.cat([state, u], dim=1)                        # [B, S+3, C]
    out = sum(full[:, i : i + S] * w[i][None, None, :] for i in range(D_CONV))
    new_state = (full[:, S : S + D_CONV - 1] if S >= D_CONV - 1
                 else full[:, -(D_CONV - 1):])
    return out, new_state


def _split_proj(zxbcdt: torch.Tensor, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di : 2 * di]
    Bm = zxbcdt[..., 2 * di : 2 * di + n]
    Cm = zxbcdt[..., 2 * di + n : 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n :]
    return z, x, Bm, Cm, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_forward(h: torch.Tensor, p: dict, *, cfg,
                   init_state: Optional[torch.Tensor] = None,
                   conv_state: Optional[torch.Tensor] = None):
    """Full-sequence Mamba2 mixer over ``h`` ``[B, S, D]`` (post-norm).
    Returns (out ``[B, S, D]``, (final state, conv state))."""
    B, S, D = h.shape
    di, nh, hp, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = matmul(h, p["in_proj"])
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    xbc, new_conv = causal_conv(torch.cat([x, Bm, Cm], dim=-1), p["conv_w"],
                                conv_state)
    xbc = F.silu(xbc)
    x, Bm, Cm = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]

    dt = _softplus(dt.float() + p["dt_bias"])                  # [B, S, nh]
    A = -torch.exp(widen(p["A_log"], torch.float32))           # [nh]
    xh = x.reshape(B, S, nh, hp)
    y, final = ssd_chunked(xh * dt[..., None].to(xh.dtype), dt * A, Bm, Cm,
                           cfg.ssm_chunk, init_state)
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z), p["out_norm"], cfg.rmsnorm_eps)
    return matmul(y, p["out_proj"]), (final, new_conv)


def mamba2_decode(h: torch.Tensor, p: dict, *, cfg, state: torch.Tensor,
                  conv_state: torch.Tensor):
    """One-token recurrent Mamba2 step over ``h`` ``[B, 1, D]``; ``state``
    ``[B, nh, hp, n]``, ``conv_state`` ``[B, D_CONV-1, conv_dim]``.
    Returns (out ``[B, 1, D]``, (state, conv state))."""
    B = h.shape[0]
    di, nh, hp, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = matmul(h[:, 0], p["in_proj"])
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    u = torch.cat([x, Bm, Cm], dim=-1)[:, None]                # [B, 1, C]
    out_c, new_conv = causal_conv(u, p["conv_w"], conv_state)
    xbc = F.silu(out_c[:, 0])
    x, Bm, Cm = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]

    dt = _softplus(dt.float() + p["dt_bias"])                  # [B, nh]
    A = -torch.exp(widen(p["A_log"], torch.float32))
    xh = x.reshape(B, nh, hp)
    y, new_state = ssd_decode_step(xh * dt[..., None].to(xh.dtype), dt * A,
                                   Bm, Cm, state)
    y = y + xh * p["D_skip"][None, :, None]
    y = y.reshape(B, di)
    y = rmsnorm(y * F.silu(z), p["out_norm"], cfg.rmsnorm_eps)
    return matmul(y, p["out_proj"])[:, None], (new_state, new_conv)


def mixer(fn, h: torch.Tensor, p: dict, *, cfg, **states):
    """``fn(h, p, cfg=cfg, **states)`` — :func:`mamba2_forward` or
    :func:`mamba2_decode` — for a DTensor ``h`` too. JAX's rules leave the
    mixer unsplit over ``model`` (``in_proj`` and ``out_proj`` shard over
    ``data`` only), so it runs batch-parallel on local shards: the batch
    as ``h`` has it, the weights gathered, the states' batch as ``h``'s.
    The weights' gradients leave as partial sums over the batch's axes."""
    if not isinstance(h, DTensor):
        return fn(h, p, cfg=cfg, **states)
    mesh = h.device_mesh
    bp = tuple(Shard(0) if pl == Shard(0) else Replicate()
               for pl in h.placements)
    rep = (Replicate(),) * mesh.ndim
    grad_w = tuple(Partial() if pl == Shard(0) else pl for pl in bp)
    names = sorted(p)
    held = [k for k, v in states.items() if v is not None]

    def local(h, *args):
        w = dict(zip(names, args))
        out, (state, conv) = fn(h, w, cfg=cfg,
                                **dict(zip(held, args[len(names):])))
        return out, state, conv

    out, state, conv = local_map(
        local, out_placements=(bp, bp, bp),
        in_placements=(bp,) + (rep,) * len(names) + (bp,) * len(held),
        in_grad_placements=(bp,) + (grad_w,) * len(names) + (bp,) * len(held),
        device_mesh=mesh, redistribute_inputs=True)(
        h, *(p[k] for k in names), *(states[k] for k in held))
    return out, (state, conv)
