"""Minimal npz checkpointing for parameter and optimizer trees: the JAX
package's format (``repro/training/checkpoint.py``).

Leaves are written as ``leaf_{i}`` in the order ``jax.tree_util``
flattens the same tree — a dict's keys sorted, depth first; a tuple or
NamedTuple (``AdamWState``) in field order — with a json sidecar, so a
checkpoint either package writes loads into the other's tree. bf16 leaves
are written as f32 (numpy has no bf16; the widening is exact) and cast
back on load; a bf16 leaf JAX wrote (2-byte void entries) is read as its
bits.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(x, it) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return f"{type(tree).__name__}(" + ", ".join(
            _describe(x) for x in tree) + ")"
    return "*"


def _to_numpy(x) -> np.ndarray:
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(_leaves(tree))}
    np.savez(_npz(path), **arrays)
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump({"treedef": _describe(tree), "n_leaves": len(arrays),
                   "metadata": metadata or {}}, f)


def _to_torch(a: np.ndarray, like) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # JAX's bf16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    like = torch.as_tensor(like)
    return t.to(device=like.device, dtype=like.dtype)


def load(path: str, like_tree):
    """Load into the structure of ``like_tree`` (leaf order must match);
    each leaf takes the dtype and device of the leaf it replaces."""
    data = np.load(_npz(path))
    leaves = _leaves(like_tree)
    assert len(leaves) == len(data.files), \
        f"checkpoint has {len(data.files)} leaves, expected {len(leaves)}"
    new = []
    for i, old in enumerate(leaves):
        a = data[f"leaf_{i}"]
        assert tuple(a.shape) == tuple(old.shape), (a.shape, old.shape)
        new.append(_to_torch(a, old))
    return _rebuild(like_tree, iter(new))
