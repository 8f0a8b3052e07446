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

The ``shard`` hook (``shard(x, tag) -> x``, :func:`noshard` by default)
is called at the JAX package's tag sites; ``launch.sharding.ShardingRules.
shard`` passes there to lay DTensor activations out over a mesh. On
DTensors, :func:`attention` runs the kernel on each rank's local shards,
and :func:`moe_block` runs every expert.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rope_freqs


def noshard(x: torch.Tensor, tag: str) -> torch.Tensor:
    """The default ``shard`` hook: no layout constraint."""
    return x


class _Constrain(torch.autograd.Function):
    """A DTensor laid out as ``placements`` forward, and its gradient laid
    out the same way backward."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(placements=placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=ctx.placements), None


def constrain(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements``; where autograd records, its
    gradient is redistributed to them too (as JAX's sharding constraint
    binds the cotangent), else DTensor would lay the gradient out as each
    backward op's rule prefers."""
    placements = tuple(placements)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, placements)
    return x if tuple(x.placements) == placements else x.redistribute(
        placements=placements)


def shard_index(mesh, dims) -> int:
    """This rank's shard of a tensor dim split over the mesh dims ``dims``
    (major to minor, as DTensor splits it)."""
    coord = mesh.get_coordinate()
    r = 0
    for i in dims:
        r = r * mesh.size(i) + coord[i]
    return r


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of an embedding table. A DTensor table first
    gathers its FSDP shards (ZeRO-3, as the products' weights do), keeping
    the vocab split; the lookup then masks each rank's rows, and the
    partial rows are summed over the vocab shards at once (a masked
    partial sum can be reduced only once)."""
    if not isinstance(table, DTensor):
        return table[ids]
    table = table.redistribute(placements=[
        pl if pl == Shard(0) else Replicate() for pl in table.placements])
    out = F.embedding(ids, table)
    return out.redistribute(placements=[
        Replicate() if pl.is_partial() else pl for pl in out.placements])


# --------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype jnp's promotion gives the JAX package's
    einsum: a bf16 weight meets f32 activations in collective recovery
    (the cached KV is f32), and is cast at use, never stored twice. No
    copy when the dtypes agree."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ widen(w, dt)


def widen(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Parameter ``w`` in the wider dtype ``dt`` for one use: where the
    dtypes differ, a cast whose operand bytes (in ``w``'s own dtype) are
    counted as ``model.cast_bytes`` (``repro_torch.spans``)."""
    if w.dtype != dt:
        spans.count("model.cast_bytes", w.nbytes)
    return w.to(dt)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + widen(scale, torch.float32))).to(dt)


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
    q ``[B, Sq, H, hd]``, k/v ``[B, Sk, KV, hd]``.

    On DTensors (a sharded model) the kernel, or on the CPU its plain
    version, runs on each rank's local shards (:func:`_local_attention`)."""
    if isinstance(q, DTensor):
        return _local_attention(q, k, v, q_pos, window, softcap)
    return ops.flash_attention(q, k, v, q_pos=q_pos, window=window,
                               softcap=softcap)


def _local_attention(q, k, v, q_pos, window: int, softcap: float):
    """:func:`attention` of DTensors through ``local_map``: a DTensor has
    no ``data_ptr`` for the kernel's launcher. The batch stays sharded as
    q's is, the sequence whole. Where q's heads are sharded (``act_heads``)
    and K/V's are not (``act_kv_heads``), a rank's h = H/m q heads ``[r h,
    (r+1) h)`` read the KV heads ``[r h // G, ...)`` of their groups
    (h / G of them, or one where the h heads lie inside one group of G),
    which it slices out of its K/V: the kernel maps local head i to local
    KV head i // (local heads / local KV heads). Where neither of h and G
    divides the other, q's heads are gathered instead. K/V's gradients
    then differ by rank, so they leave as partial sums over the head
    axes."""
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    heads = [i for i, p in enumerate(qp) if p == Shard(2)]
    m = math.prod(mesh.size(i) for i in heads)
    if (H // m) % G and G % (H // m):
        qp = [Replicate() if p == Shard(2) else p for p in qp]
        heads, m = [], 1
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in qp]
    grad_kv = [Partial() if i in heads else p for i, p in enumerate(bp)]
    kv0, n_kv = shard_index(mesh, heads) * (H // m) // G, max(1, H // m // G)
    if not isinstance(q_pos, DTensor):
        q_pos = distribute_tensor(q_pos, mesh, [Replicate()] * mesh.ndim,
                                  src_data_rank=None)

    def local(q, k, v, q_pos):
        if m > 1:
            k, v = k[:, :, kv0:kv0 + n_kv], v[:, :, kv0:kv0 + n_kv]
        return ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_pos=q_pos.contiguous(), window=window, softcap=softcap)

    return local_map(local, out_placements=qp, in_placements=(qp, bp, bp, bp),
                     in_grad_placements=(qp, grad_kv, grad_kv, bp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, q_pos)


def _split_heads(y: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    """``[B, S, nh * hd]`` -> ``[B, S, nh, hd]``. A DTensor whose last dim
    is split over more ranks than ``nh`` divides (8 KV heads on a 16-way
    axis) is gathered there first, so the view never cuts a head."""
    if isinstance(y, DTensor):
        split = [i for i, pl in enumerate(y.placements) if pl == Shard(2)]
        if nh % math.prod(y.device_mesh.size(i) for i in split):
            y = y.redistribute(placements=[
                Replicate() if pl == Shard(2) else pl for pl in y.placements])
    return y.view(*y.shape[:2], nh, hd)


def project_qkv(x: torch.Tensor, p: dict, cfg, shard=noshard):
    """q ``[B, S, H, hd]`` and k/v ``[B, S, KV, hd]``: bias added, tagged
    (``act_heads``, ``act_kv_heads``), then with ``cfg.qk_norm`` each head
    of q and k RMS-normed (``q_norm`` / ``k_norm`` ``[hd]``), as JAX does
    it at every attention site; no RoPE. Every attention of the port
    projects here, so cached keys are stored normed."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def proj(w, b, nh, tag):
        y = matmul(x, p[w])
        return shard(_split_heads(y + p[b] if b in p else y, nh, hd), tag)

    q, k = proj("wq", "bq", H, "act_heads"), proj("wk", "bk", KV,
                                                  "act_kv_heads")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    return q, k, proj("wv", "bv", KV, "act_kv_heads")


def out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    """``[B, S, H, hd]`` attention output -> ``[B, S, D]``. A DTensor's
    merged heads keep their layout in the backward, so the gradient never
    splits a head (25 heads, 1600 columns on a 16-way axis)."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if isinstance(o, DTensor):
        o = constrain(o, o.placements)
    return matmul(o, p["wo"])


def swiglu_mlp(x: torch.Tensor, p: dict, shard=noshard) -> torch.Tensor:
    h = shard(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
              "act_ffn")
    return shard(matmul(h, p["w_down"]), "act_resid")


def moe_route(xg: torch.Tensor, router: torch.Tensor, K: int):
    """The router of :func:`moe_block` on token groups ``xg`` ``[G, tg,
    D]``: (f32 probabilities ``[G, tg, E]``, the top ``K`` weights
    renormalised, their expert indices ``[G, tg, K]``). Ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them (a zero pad row
    has uniform probabilities): a stable descending sort, first K. As
    DTensors the logits keep the groups' split, replicated elsewhere, in
    the backward too (DTensor would hand the router's product a strided
    split it cannot shard)."""
    logits = xg.float() @ widen(router, torch.float32)
    if isinstance(logits, DTensor):
        logits = constrain(logits, [Shard(0) if pl == Shard(0) else
                                    Replicate() for pl in xg.placements])
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = top.values[..., :K], top.indices[..., :K]
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _per_expert(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's ``einsum("geca,eab->gecb")`` on DTensors: each expert's rows
    ``x[:, e]`` ``[G, C, a]`` times its weight ``w[e]`` ``[a, b]``, one
    batched product over the expert axis on each rank's local shards
    (DTensor's own einsum and reshapes view local shards they cannot
    view). Per mesh dim: experts split in both stay split; x's groups
    stay split with the weight gathered there (FSDP); a split ``b``
    splits the output; a split ``a`` leaves partial sums."""
    mesh = x.device_mesh
    xin, win, out, gx, gw = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(1) or pw == Shard(0):        # experts
            dims = (Shard(1), Shard(0), Shard(1), Shard(1), Shard(0))
        elif px == Shard(0):                         # groups; w gathered
            dims = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif pw == Shard(2):                         # output features
            dims = (Replicate(), Shard(2), Shard(3), Partial(), Shard(2))
        elif px == Shard(3) or pw == Shard(1):       # contraction
            dims = (Shard(3), Shard(1), Partial(), Shard(3), Shard(1))
        else:
            dims = (Replicate(),) * 3 + (Replicate(),) * 2
        for lst, pl in zip((xin, win, out, gx, gw), dims):
            lst.append(pl)

    def local(x, w):
        G, E, C, _ = x.shape
        y = torch.bmm(x.transpose(0, 1).reshape(E, G * C, -1), w)
        return y.reshape(E, G, C, -1).transpose(0, 1).contiguous()

    return local_map(local, out_placements=out, in_placements=(xin, win),
                     in_grad_placements=(gx, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def moe_block(x: torch.Tensor, p: dict, cfg, group_size: int = 1024,
              shard=noshard):
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
    every row of the groups, the pad rows included, as JAX does. A
    DTensor's routing is never read on the host: every expert runs, as
    JAX's three einsums over ``[G, E, C, ·]`` (the ``moe_ffn`` tag's
    layout)."""
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
    token_ids = torch.arange(tg, device=x.device)[None, :, None]
    slot_token = torch.full((G, E * C + 1), tg, dtype=torch.long,
                            device=x.device).scatter(
        1, flat_slot.reshape(G, -1), token_ids.expand(G, tg, K).reshape(G, -1))
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    x_disp = x_pad.gather(1, slot_token[:, :E * C, None].expand(-1, -1, D))
    x_disp = shard(x_disp.view(G, E, C, D), "moe_dispatch")

    dt = torch.promote_types(x.dtype, p["w_down"].dtype)
    if isinstance(x_disp, DTensor):
        wg, wu, wd = (widen(p[w], dt) for w in ("w_gate", "w_up", "w_down"))
        xd = x_disp.to(dt)
        h = shard(F.silu(_per_expert(xd, wg)) * _per_expert(xd, wu),
                  "moe_ffn")
        y_disp = _per_expert(h, wd)
    else:
        # experts, one weight slice at a time
        y_disp = torch.zeros((G, E, C, D), dtype=dt, device=x.device)
        for e in torch.unique(flat_slot[flat_slot < E * C] // C).tolist():
            xe = x_disp[:, e]
            h = F.silu(matmul(xe, p["w_gate"][e])) * matmul(xe, p["w_up"][e])
            y_disp[:, e] = matmul(h, p["w_down"][e])
    y_disp = shard(y_disp, "moe_dispatch")

    # combine: each token's kept slots, weighted and summed
    y_flat = torch.cat([y_disp.reshape(G, E * C, D),
                        y_disp.new_zeros((G, 1, D))], dim=1)
    y_choice = y_flat.gather(
        1, flat_slot.reshape(G, -1, 1).expand(-1, -1, D)).view(G, tg, K, D)
    y = (y_choice * topw[..., None].to(dt)).sum(dim=2)
    out = y.reshape(-1, D)[:T].reshape(B, S, D)
    if cfg.dense_residual:
        out = out + swiglu_mlp(x, p["dense"], shard)
    me = probs.reshape(-1, E).mean(dim=0)
    ce = tok_expert.reshape(-1, E).float().mean(dim=0)
    return shard(out, "act_resid"), E * (me * ce).sum()


def feed_forward(h: torch.Tensor, p: dict, cfg, shard=noshard):
    """A layer's second half on the residual stream ``h``: ``h`` plus the
    MoE block or the SwiGLU MLP of ``rmsnorm(h, ln2)``, or ``h`` as it is
    where the layer has neither (an SSM layer). Returns (h, the layer's
    MoE load-balance loss, or None without MoE)."""
    if cfg.is_moe:
        out, aux = moe_block(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps), p["moe"],
                             cfg, shard=shard)
        return h + out, aux
    if "mlp" in p:
        return h + swiglu_mlp(rmsnorm(h, p["ln2"], cfg.rmsnorm_eps),
                              p["mlp"], shard), None
    return h, None
