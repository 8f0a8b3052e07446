"""Sharding rules: parameters, optimizer state, activations and caches for
every (architecture x input shape x mesh) combination — the JAX package's
``repro.launch.sharding``, stated as DTensor placements.

Strategy (the JAX module's):
  * weights: tensor-parallel over ``model`` (heads / d_ff / experts /
    vocab) + FSDP over ``data`` on the other large dim (ZeRO-3 style);
  * batch: sharded over (pod, data) for train / prefill / decode;
  * long_500k (batch=1): the KV cache is sequence-sharded over ``data``
    (and ``model``) instead;
  * MoE: expert-parallel over ``model`` when n_experts divides the axis,
    tensor-parallel within experts otherwise (grok's 8 experts on a
    16-way axis).

A spec is a :class:`P`, one entry per tensor dim: an axis name, a tuple
of axis names (major to minor), or ``None``. :meth:`ShardingRules.
placements` turns a spec into one ``Shard``/``Replicate`` per mesh dim.
Activations are annotated through the ``shard`` callable threaded into
the model code (:meth:`ShardingRules.shard`, the counterpart of
``with_sharding_constraint``): it redistributes a DTensor to its tag's
placements and returns a plain tensor unchanged. The rules need only the
mesh's axis names and sizes, so they also run on an :class:`AbstractMesh`
(no process group); :func:`distribute_params` needs a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import constrain


class P(tuple):
    """A partition spec: one entry per leading tensor dim (missing trailing
    entries are ``None``). Entries are normalised as JAX's
    ``PartitionSpec`` normalises them: a one-name tuple becomes the name,
    an empty tuple ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without devices or ranks: enough to plan
    shardings (the rules, their placements, local shapes) without a
    process group, as JAX's ``AbstractMesh``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclass
class ShardingRules:
    mesh: object                         # DeviceMesh or AbstractMesh
    cfg: ModelConfig
    batch_axes: Tuple[str, ...]          # axes sharding the batch dim
    fsdp_axis: Optional[str] = "data"    # weight-sharding data axis (ZeRO-3)
    seq_shard: bool = False              # long-context: shard cache seq dim
    seq_parallel: bool = False           # train: shard activation seq dim
    expert_parallel: bool = field(init=False)
    model_size: int = field(init=False)

    def __post_init__(self):
        self.model_size = _axis_sizes(self.mesh)["model"]
        self.expert_parallel = (
            self.cfg.is_moe and self.cfg.n_experts % self.model_size == 0)

    # ------------------------------------------------------------- helpers
    def _axis_size(self, entry) -> int:
        sizes = _axis_sizes(self.mesh)
        if entry is None:
            return 1
        if isinstance(entry, (tuple, list)):
            n = 1
            for e in entry:
                n *= sizes[e]
            return n
        return sizes[entry]

    def sanitize(self, spec, shape) -> P:
        """Drop sharding on dims the global shape cannot divide (e.g. a
        32001-entry vocab or 25 attention heads on a 16-way axis)."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for d, entry in enumerate(entries):
            div = self._axis_size(entry)
            out.append(entry if div > 1 and shape[d] % div == 0 else
                       (entry if div == 1 else None))
        return P(*out)

    def placements(self, spec) -> tuple:
        """The DTensor placements of a (sanitized) spec: for each mesh dim,
        ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis,
        else ``Replicate()``. A tuple entry shards its dim over each of its
        axes; DTensor splits a dim over several mesh dims in mesh order,
        major first, which is JAX's order for a tuple listed in mesh order
        (the only order the rules write; any other raises)."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in mesh order "
                                 f"{names}")
            for i in idx:
                if isinstance(out[i], Shard):
                    raise ValueError(f"axis {names[i]} shards two dims of "
                                     f"{spec}")
                out[i] = Shard(d)
        return tuple(out)

    def placements_for(self, shape, *spec) -> tuple:
        return self.placements(self.sanitize(P(*spec), shape))

    # ------------------------------------------------------ activation tags
    def shard(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Redistribute a DTensor to the placements of ``tag``; a plain
        tensor, or a tag with no rule, passes through unchanged. As
        ``with_sharding_constraint`` does, it constrains the gradient too:
        in the backward the cotangent is laid out as ``tag`` says (a
        partial sum, which a row-parallel product's backward leaves, is
        reduced there), else DTensor would carry the partial sum on and
        run the next products on gathered weights."""
        if not isinstance(x, DTensor):
            return x
        spec = self.act_spec(tag, x.ndim)
        if spec is None:
            return x
        return constrain(x, self.placements_for(x.shape, *spec))

    def act_spec(self, tag: str, ndim: int):
        b = self.batch_axes
        sp = "model" if self.seq_parallel else None
        if tag == "act_resid":        # [B, S, D]
            return (b, sp, None)
        if tag == "act_heads":        # [B, S, H, hd]
            return (b, None, "model", None)
        if tag == "act_kv_heads":     # [B, S, KV, hd] (KV may not divide)
            return (b, None, None, None)
        if tag == "act_ffn":          # [B, S, F]
            return (b, None, "model")
        if tag == "logits":           # [B, S, V]
            return (b, None, "model")
        if tag == "moe_dispatch":     # [G, E, C, D]
            e = "model" if self.expert_parallel else None
            return (b, e, None, None)
        if tag == "moe_ffn":          # [G, E, C, F]
            e = "model" if self.expert_parallel else None
            f = None if self.expert_parallel else "model"
            return (b, e, None, f)
        if tag == "cache_kv":         # [L, B, S, KV, hd]
            if self.seq_shard:
                return (None, None, ("data", "model"), None, None)
            return (None, b, "model", None, None)
        return None

    # --------------------------------------------------------- param specs
    def param_spec(self, path: str, leaf) -> P:
        """Spec for one parameter leaf, by its path ("blocks/attn/wq")."""
        nd = leaf.ndim
        fsdp = self.fsdp_axis
        m = "model"
        if "embed" in path:                       # [V, D]
            return P(m, fsdp)
        if "lm_head" in path:                     # [D, V]
            return P(fsdp, m)
        if "final_norm" in path or "ln" in path or "norm" in path:
            return P(*([None] * nd))
        if "attn" in path:
            if path.endswith("wq") or path.endswith("wk") or path.endswith("wv"):
                return P(None, fsdp, m)           # [L, D, H*hd]
            if path.endswith("wo"):
                return P(None, m, fsdp)           # [L, H*hd, D]
            if path.endswith("bq") or path.endswith("bk") or path.endswith("bv"):
                return P(None, m)                 # [L, H*hd]
            return P(*([None] * nd))
        if "moe" in path:
            if path.endswith("router"):
                return P(None, fsdp, None)        # [L, D, E]
            if self.expert_parallel:
                if path.endswith("w_down"):       # [L, E, F, D]
                    return P(None, m, None, fsdp) if nd == 4 else P(None, m, fsdp)
                if nd == 4:                       # [L, E, D, F]
                    return P(None, m, fsdp, None)
            else:
                if path.endswith("w_down"):
                    return P(None, None, m, fsdp) if nd == 4 else P(None, m, fsdp)
                if nd == 4:
                    return P(None, None, fsdp, m)
            # dense residual (arctic): [L, D, F] / [L, F, D]
            if path.endswith("dense/w_down"):
                return P(None, m, fsdp)
            if nd == 3:
                return P(None, fsdp, m)
            return P(*([None] * nd))
        if "mlp" in path:
            if path.endswith("w_down"):           # [L, F, D]
                return P(None, m, fsdp)
            return P(None, fsdp, m)               # [L, D, F]
        if "ssm" in path:
            if path.endswith("in_proj"):          # [L, D, d_in_proj]
                return P(None, fsdp, None)
            if path.endswith("out_proj"):         # [L, d_inner, D]
                return P(None, None, fsdp)
            return P(*([None] * nd))
        return P(*([None] * nd))

    def params_shardings(self, params: dict) -> dict:
        """The placements of every leaf, as a tree shaped like ``params``
        (the sanitized :meth:`param_spec` by the leaf's "/"-joined path)."""
        def assign(tree, path):
            if isinstance(tree, dict):
                return {k: assign(v, path + (k,)) for k, v in tree.items()}
            return self.placements_for(tree.shape, *self.param_spec(
                "/".join(path), tree))
        return assign(params, ())

    def opt_shardings(self, params_shardings: dict):
        """AdamW moments shard like their parameters; step is replicated."""
        from repro_torch.training.optimizer import AdamWState
        return AdamWState(self.placements(P()), params_shardings,
                          params_shardings)

    # ---------------------------------------------------------- data specs
    def tokens_sharding(self) -> tuple:
        return self.placements(P(self.batch_axes, None))

    def token_sharding_1d(self) -> tuple:
        return self.placements(P(self.batch_axes))

    def cache_shardings(self, cache: dict) -> dict:
        def assign(name, leaf):
            if name in ("k", "v"):
                return self.placements_for(
                    leaf.shape, *self.act_spec("cache_kv", leaf.ndim))
            if "ssm" in name:                     # [L, B, nh, hp, n]
                return self.placements_for(leaf.shape, None, self.batch_axes,
                                           "model", None, None)
            if "conv" in name:                    # [L, B, 3, convdim]
                return self.placements_for(leaf.shape, None, self.batch_axes,
                                           None, None)
            if "kv_pos" in name or "kv_valid" in name:  # [B, S]
                if self.seq_shard:
                    return self.placements_for(leaf.shape, None,
                                               ("data", "model"))
                return self.placements_for(leaf.shape, self.batch_axes, None)
            return self.placements_for(leaf.shape, self.batch_axes)  # [B]
        return {k: assign(k, v) for k, v in cache.items()}


def rules_for(cfg: ModelConfig, shape: InputShape, mesh,
              **overrides) -> ShardingRules:
    axes = tuple(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in axes if a in ("pod", "data"))
    kw: dict = dict(batch_axes=batch_axes)
    if shape.name == "long_500k":
        kw.update(batch_axes=(), seq_shard=True)
    if shape.kind == "train":
        kw.update(seq_parallel=False)
    kw.update(overrides)
    return ShardingRules(mesh, cfg, **kw)


def distribute(x: torch.Tensor, mesh, placements) -> DTensor:
    """``x`` (the same global tensor on every rank) as a DTensor: each rank
    keeps a copy of its own shard, cut with no collective
    (``src_data_rank=None``). The copy owns its storage, so an in-place
    update (AdamW) never writes into ``x`` and ``x`` can be freed."""
    d = distribute_tensor(x.detach(), mesh, list(placements),
                          src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute_params(params: dict, rules: ShardingRules) -> dict:
    """The port's parameter dict as DTensors on ``rules.mesh`` (a
    ``DeviceMesh``), each leaf placed by :meth:`ShardingRules.
    params_shardings`. Every rank passes the same global weights (the
    seeded init gives them) and keeps its shard."""
    shardings = rules.params_shardings(params)

    def walk(tree, sh):
        if isinstance(tree, dict):
            return {k: walk(v, sh[k]) for k, v in tree.items()}
        return distribute(tree, rules.mesh, sh)
    return walk(params, shardings)
