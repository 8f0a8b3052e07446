"""Training step and loop: next-token cross entropy (+ the MoE load-balance
loss), AdamW, per-layer rematerialisation — the JAX package's
``repro/training/train_loop.py`` on the port's parameter dict.

Gradients come from ``torch.autograd.grad`` over the parameter leaves;
attention differentiates through ``ops.flash_attention``'s autograd
function, whose backward is the hand-written kernel on the card. JAX's
``shard`` hook reaches the forward (``launch.sharding``: DTensor
parameters train sharded, the optimizer walking local shards); JAX's
``unroll`` is a ``lax.scan`` knob that eager layers do not need.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_params
from repro_torch.models.layers import noshard, shard_index
from repro_torch.models.transformer import logits_of, resolve_device, sharded
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_adamw, tree_leaves)


def _label_logp(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """``sum(mask * log p(label))`` over the positions of logits [B,S,V]."""
    if isinstance(logits, DTensor):
        return _vocab_parallel_logp(logits, labels, mask)
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return (ll * mask).sum()


def _vocab_parallel_logp(logits, labels, mask):
    """:func:`_label_logp` of DTensor logits whose vocab may be split
    (the ``logits`` tag), as XLA partitions a log-softmax: the max and the
    sum of exponentials reduce over the vocab shards, and each rank picks
    the labels inside its shard (zero elsewhere, summed over the shards),
    so no rank holds the whole vocab. The max is detached: the
    log-sum-exp does not depend on it. Each reduction is laid out as the
    batch is, replicated over the vocab's axes; DTensor would otherwise
    scatter it over the batch, and its backward would need all-to-alls
    back to the logits' layout."""
    mesh = logits.device_mesh
    vocab = [i for i, pl in enumerate(logits.placements) if pl == Shard(2)]
    lp = [pl if pl in (Shard(0), Shard(2)) else Replicate()
          for pl in logits.placements]
    bp = [Shard(0) if pl == Shard(0) else Replicate() for pl in lp]
    m = logits.amax(dim=-1, keepdim=True).detach().redistribute(
        placements=bp)
    lse = m[..., 0] + (logits - m).exp().sum(dim=-1).redistribute(
        placements=bp).log()
    V = logits.shape[-1] // math.prod(mesh.size(i) for i in vocab)
    v0 = shard_index(mesh, vocab) * V

    def pick(lg, lab):
        idx = lab.long() - v0
        inside = (idx >= 0) & (idx < V)
        got = lg.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    if not isinstance(labels, DTensor):
        labels = distribute_tensor(labels, mesh, [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    picked = local_map(
        pick, out_placements=[Partial() if i in vocab else pl
                              for i, pl in enumerate(bp)],
        in_placements=(lp, bp), in_grad_placements=(lp, bp),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return ((picked.redistribute(placements=bp) - lse) * mask).sum()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy. logits [B,S,V], labels/mask [B,S]."""
    return -_label_logp(logits, labels, mask) / torch.clamp(mask.sum(),
                                                            min=1.0)


def _chunk_nll(h_c, l_c, m_c, params, cfg):
    return _label_logp(logits_of(params, cfg, h_c), l_c, m_c)


def chunked_xent(params: dict, cfg: ModelConfig, h: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Next-token xent of the pre-norm hidden state ``h`` [B, S, D] computed
    per sequence chunk, so the full [B, S, V] logits are never held: each
    chunk's logits are checkpointed (recomputed in the backward), and the
    sums run over the chunks in order, as JAX's ``lax.scan`` does."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    num = torch.zeros((), dtype=torch.float32, device=h.device)
    den = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S + pad, chunk):
        sl = slice(c, c + chunk)
        nll = torch.utils.checkpoint.checkpoint(
            _chunk_nll, h[:, sl], labels[:, sl], mask[:, sl], params, cfg,
            use_reentrant=False)
        num = num - nll
        den = den + mask[:, sl].sum()
    return num / torch.clamp(den, min=1.0)


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            mask: torch.Tensor, *, shard=noshard, remat: bool = True,
            aux_weight: float = 0.01,
            frontend_embeds: Optional[torch.Tensor] = None):
    """(total loss, {"xent", "aux"}): the next-token xent of ``tokens``
    [B, S] under ``mask`` (chunked when ``cfg.xent_chunk``), plus
    ``aux_weight`` times the MoE load-balance loss for an MoE model."""
    with sharded(params):
        if cfg.xent_chunk:
            h, aux = forward(params, cfg, tokens, shard=shard, remat=remat,
                             frontend_embeds=frontend_embeds,
                             return_hidden=True)
            loss = chunked_xent(params, cfg, h[:, :-1], tokens[:, 1:],
                                mask[:, 1:], cfg.xent_chunk)
        else:
            logits, aux = forward(params, cfg, tokens, shard=shard,
                                  remat=remat,
                                  frontend_embeds=frontend_embeds)
            loss = softmax_xent(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
        total = loss + (aux_weight * aux if cfg.is_moe else 0.0)
    return total, {"xent": loss, "aux": aux}


def _with_grad(params: dict):
    """The parameter tree with every leaf a fresh autograd leaf (sharing
    the parameters' storage), and those leaves in tree order."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree.detach().requires_grad_(True)

    tree = walk(params)
    return tree, [leaf for _, leaf in tree_leaves(tree)]


def value_and_grad(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   mask: torch.Tensor, *, shard=noshard, remat: bool = True,
                   frontend_embeds: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None):
    """(loss, parts, grads): :func:`loss_fn` and its gradient with respect
    to every parameter leaf, as a tree shaped like ``params``. ``mark``,
    if given, is called with ``"forward"`` once the loss is computed and
    ``"backward"`` once the gradients are (a timer's hook)."""
    tree, leaves = _with_grad(params)
    with torch.enable_grad(), sharded(params):
        loss, parts = loss_fn(tree, cfg, tokens, mask, shard=shard,
                              remat=remat, frontend_embeds=frontend_embeds)
        if mark:
            mark("forward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    if mark:
        mark("backward")
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    out: dict = {}
    for (path, _), g in zip(tree_leaves(params), grads):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, out


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *, shard=noshard,
                    remat: bool = True,
                    mark: Optional[Callable[[str], None]] = None) -> Callable:
    """``train_step(params, opt_state, tokens, mask) -> (params, opt_state,
    metrics)`` with JAX's metrics: ``loss``, ``xent``, ``aux``,
    ``grad_norm``, ``lr``. The parameters and moments are updated in
    place (``optimizer.adamw_update``). ``mark`` as in
    :func:`value_and_grad`, and ``"optimizer"`` after the update."""

    def train_step(params, opt_state, tokens, mask):
        loss, parts, grads = value_and_grad(params, cfg, tokens, mask,
                                            shard=shard, remat=remat,
                                            mark=mark)
        params, opt_state, om = adamw_update(opt, params, grads, opt_state)
        del grads
        if mark:
            mark("optimizer")
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


@dataclass
class TrainResult:
    losses: list
    steps: int
    wall_s: float
    params: Optional[dict] = None
    opt_state: Optional[object] = None


def train(cfg: ModelConfig, opt: AdamWConfig, data_iter, n_steps: int,
          *, seed: int = 0, log_every: int = 10,
          params: Optional[dict] = None, log=print,
          device=None) -> TrainResult:
    """Single-device training loop (the examples' and the smoke checks').
    Runs on the CUDA device unless ``device`` names another; ``params``
    (default: ``init_params(cfg, seed)``) are trained in place. Each step
    reads its loss back to the host. Batches are (tokens, mask) pairs of
    numpy arrays (``SyntheticTokens``) or tensors."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, device=dev)
    opt_state = init_adamw(params)
    step_fn = make_train_step(cfg, opt)
    losses = []
    t0 = time.time()
    for i, (tokens, mask) in enumerate(data_iter):
        if i >= n_steps:
            break
        params, opt_state, m = step_fn(
            params, opt_state, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(mask, device=dev))
        losses.append(float(m["loss"]))
        if log_every and i % log_every == 0:
            log(f"step {i:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e}")
    return TrainResult(losses, len(losses), time.time() - t0, params,
                       opt_state)
