"""AdamW on the port's parameter dict: f32 moments, decoupled weight
decay, global-norm clipping, cosine schedule with warmup — the JAX
package's ``repro/training/optimizer.py``, leaf by leaf.

The update is computed in f32 and cast back to each parameter's dtype, as
JAX does, but IN PLACE: parameters and moments are overwritten and
returned (JAX returns new trees). At Qwen3-4B a new tree would double the
8 GB of bf16 weights, and each f32 temporary of the largest leaf
(``blocks.mlp.w_gate``, ``[36, 2560, 9728]``) is 3.6 GB, so a stacked leaf
is updated one slice of at most :data:`PART` elements at a time.

DTensor parameters (a sharded model, ``launch.sharding``) take moments
placed like themselves; the update is elementwise, so it walks each
rank's local shards, and only the global norm combines across ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

#: elements of one slice of a leaf updated at a time (f32 temporaries of
#: at most 256 MB each)
PART = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d, on the parameters' device
    m: dict                     # f32, the parameters' tree
    v: dict


def tree_leaves(tree) -> List[Tuple[tuple, torch.Tensor]]:
    """``(path, leaf)`` of a nested dict in ``jax.tree_util`` order: keys
    sorted, depth first."""
    if isinstance(tree, dict):
        return [(((k,) + p), leaf) for k in sorted(tree)
                for p, leaf in tree_leaves(tree[k])]
    return [((), tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def parts(x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``x`` along its first axis of at most :data:`PART`
    elements each (``x`` itself when it is that small)."""
    if x.dim() == 0 or x.numel() <= PART:
        yield x
        return
    n = max(1, PART // max(1, x[0].numel()))
    for i in range(0, x.shape[0], n):
        yield x[i:i + n]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def init_adamw(params: dict) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = tree_leaves(params)[0][1].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.clone, zeros))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at ``step``: linear warmup, then a cosine
    decay to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = step.float()
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _square_sums(g: torch.Tensor) -> Iterator[torch.Tensor]:
    """f32 sums of ``g^2``, one per slice of :func:`parts`. A DTensor leaf
    gives one: its local slices' sum, added over the mesh dims that shard
    it."""
    if not isinstance(g, DTensor):
        yield from (part.float().square().sum() for part in parts(g))
        return
    s = sum(part.float().square().sum() for part in parts(g.to_local()))
    yield DTensor.from_local(
        s, g.device_mesh, [Partial() if isinstance(pl, Shard) else pl
                           for pl in g.placements]).full_tensor()


def global_norm(grads: dict) -> torch.Tensor:
    """f32 ``sqrt(sum g^2)`` over every leaf (each summed in f32, slice by
    slice)."""
    total = None
    for _, g in tree_leaves(grads):
        for s in _square_sums(g):
            total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in f32, and
    the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: AdamWState):
    """One AdamW step, IN PLACE on ``params`` and the state's moments.
    Returns (params, state', metrics ``{"grad_norm", "lr"}``)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for path, p in tree_leaves(params):
        g, m, v = _get(grads, path), _get(state.m, path), _get(state.v, path)
        if isinstance(p, DTensor) and g.placements != p.placements:
            g = g.redistribute(placements=p.placements)
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        for ps, gs, ms, vs in zip(parts(p), parts(g), parts(m), parts(v)):
            gf = gs.float() * scale
            ms.mul_(b1).add_(gf * (1 - b1))
            vs.mul_(b2).add_(gf * (1 - b2) * gf)
            del gf
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            pf = ps.float()
            delta += cfg.weight_decay * pf
            ps.copy_(pf - lr * delta)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gn,
                                                        "lr": lr}


__all__ = ["AdamWConfig", "AdamWState", "init_adamw", "lr_at",
           "clip_by_global_norm", "adamw_update", "global_norm",
           "tree_leaves", "tree_map"]
