"""Walkthrough of the paper's storage pipeline on one All-Gather round, in
PyTorch: collective recovery -> reuse plan -> Master-Mirror block-sparse
diffs -> the restore paths, with exactness checks at every step. The twin
of ``examples/compression_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.compression_demo \\
        [--agents 6] [--device cpu]

Without ``--device`` it runs on the CUDA device (and raises when there is
none); the restores then launch the ``fused_diff_restore`` and
``fused_family_restore`` kernels. The model is the f32 smoke
configuration of qwen2.5-7b with random weights from ``--seed``;
``walkthrough`` takes any parameters and tokens (``chip_smoke.py`` drives
it at Qwen2.5-7B's full width).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.collector import CollectiveResult, KVCollector
from repro_torch.core.diff_store import (MasterCache, MirrorHandle,
                                         build_round_family,
                                         compression_stats)
from repro_torch.core.pic import n_sel_for_blocks
from repro_torch.core.restore import (dense_restore, dense_restore_paged,
                                      fused_restore_family_paged,
                                      fused_restore_paged, gather_pages)
from repro_torch.models import init_params
from repro_torch.models.transformer import prefill, resolve_device


@dataclass
class GroupInputs:
    """One compatible All-Gather round group: N agents, each prompt a
    private prefix followed by the shared blocks, whose KV was cached by
    a standalone prefill at positions 0.. (so it lands at other offsets
    in the target prompt and needs RoPE realignment)."""

    tokens: torch.Tensor      # [N, S]
    shared_k: torch.Tensor    # [L, S, KV, hd] f32, zero where uncached
    shared_v: torch.Tensor
    src: torch.Tensor         # [S] int32 source positions
    mask: torch.Tensor        # [S] bool shared-cached positions
    n_sel: int
    S: int


def group_tokens(vocab_size: int, n_agents: int, *, priv_len: int = 64,
                 block_len: int = 128, n_blocks: int | None = None,
                 seed: int = 0) -> np.ndarray:
    """Token ids ``[N, priv_len + n_blocks * block_len]`` (int32) from a
    numpy seed: each agent's private prefix, then the same shared blocks
    (``n_blocks`` defaults to one per agent)."""
    n_blocks = n_blocks if n_blocks is not None else n_agents
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab_size, n_blocks * block_len)
    priv = rng.integers(0, vocab_size, (n_agents, priv_len))
    return np.concatenate(
        [priv, np.broadcast_to(shared, (n_agents, shared.size))],
        axis=1).astype(np.int32)


def make_group(params: dict, cfg, tokens, priv_len: int, *,
               ratio: float = 0.1, block: int = 32) -> GroupInputs:
    """The JAX ``benchmarks.common.make_group`` on given tokens: cache the
    shared suffix ``tokens[0, priv_len:]`` with one standalone prefill
    and lay it out at its prompt positions. The cached KV is f32 (as the
    JAX helper and the serving engine assemble it). ``n_sel`` is a whole
    number of ``block``-token blocks (JAX's helper: 32)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(np.array(tokens), dtype=torch.int64,
                             device=dev)
    N, S = tokens.shape
    shared_len = S - priv_len
    _, c = prefill(params, cfg, tokens[:1, priv_len:])
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    sk = torch.zeros((L, S, KV, hd), dtype=torch.float32, device=dev)
    sv = torch.zeros_like(sk)
    sk[:, priv_len:] = c["k"][:, 0]
    sv[:, priv_len:] = c["v"][:, 0]
    src = torch.arange(S, dtype=torch.int32, device=dev)
    src[priv_len:] = torch.arange(shared_len, dtype=torch.int32, device=dev)
    mask = torch.zeros(S, dtype=torch.bool, device=dev)
    mask[priv_len:] = True
    n_sel = n_sel_for_blocks(~mask.cpu().numpy(), block, ratio)
    return GroupInputs(tokens, sk, sv, src, mask, n_sel, S)


@dataclass
class Walkthrough:
    """What one walkthrough produced, for callers that time or compare
    its stages."""

    group: GroupInputs
    result: CollectiveResult
    ks: torch.Tensor          # [N, L, S, KV, hd] recovered caches
    vs: torch.Tensor
    master: MasterCache
    handles: List[MirrorHandle]
    mirrors: List[int]        # agent index of each handle
    stats: dict               # compression_stats
    slot_maps: np.ndarray     # int32 [M, nb]: mirror m's pages
    pools: dict               # path name -> (pool_k, pool_v)


def _fresh_pools(handles, n_pages: int):
    m = handles[0].master.k
    L, _, KV, hd = m.shape
    bt = handles[0].diff.block_tokens
    pk = torch.zeros((L, n_pages, bt, KV, hd), dtype=m.dtype, device=m.device)
    return pk, torch.zeros_like(pk)


def walkthrough(params: dict, cfg, tokens, priv_len: int, *,
                ratio: float = 0.05, block_select: int = 32,
                log=print) -> Walkthrough:
    """Collective recovery of the group ``tokens`` ([N, S]: private
    prefixes of ``priv_len`` then shared blocks), the reuse plan, the
    Master-Mirror family and its compression, then every mirror restored
    three ways into fresh pools — ``fused_restore_family_paged`` (one
    launch), ``fused_restore_paged`` per mirror, ``dense_restore_paged``
    — checking bit for bit that dense restore reproduces each mirror's
    recovered KV, that the three pools are equal, and that each mirror's
    pages in the family pool hold its recovered KV."""
    g = make_group(params, cfg, tokens, priv_len, ratio=ratio,
                   block=block_select)
    N = g.tokens.shape[0]
    ids = [f"agent{i}" for i in range(N)]
    log(f"round: {N} agents, prompt {g.S} tokens "
        f"({int(g.mask.sum())} shared), n_sel={g.n_sel}")

    coll = KVCollector(params, cfg, block_select=block_select,
                       recompute_ratio=ratio)
    res = coll.collective_reuse(ids, g.tokens, g.shared_k, g.shared_v, g.src,
                                g.mask, g.n_sel)
    log(f"reuse plan: master={ids[res.plan.master]} "
        f"deviations={np.round(res.plan.deviations, 1)}")

    ks = res.pic.recovered_k.transpose(0, 1).contiguous()
    vs = res.pic.recovered_v.transpose(0, 1).contiguous()
    master, handles = build_round_family(ids, ks, vs, np.arange(g.S),
                                         res.plan.master,
                                         block_tokens=block_select)
    st = compression_stats(master, handles)
    log(f"diff store: mirror={st['per_mirror_ratio']:.1f}x "
        f"({st['avg_changed_blocks']:.1f}/{st['total_blocks']} blocks), "
        f"family {st['compression_ratio']:.1f}x")

    # restore exactness: Master + diff reproduce every Mirror bitwise
    mirrors = [i for i in range(N) if i != res.plan.master]
    for i, h in zip(mirrors, handles):
        rk, rv = dense_restore(h, cfg.rope_theta)
        assert torch.equal(rk, ks[i]) and torch.equal(rv, vs[i]), ids[i]
    log("dense restore: exact")

    pools = {}
    if handles:
        M = len(handles)
        nb = -(-g.S // handles[0].diff.block_tokens)
        slot_maps = np.arange(M * nb, dtype=np.int32).reshape(M, nb)
        pools["family"] = fused_restore_family_paged(
            handles, cfg.rope_theta, slot_maps,
            *_fresh_pools(handles, M * nb))
        pk, pv = _fresh_pools(handles, M * nb)
        for m, h in enumerate(handles):
            pk, pv = fused_restore_paged(h, cfg.rope_theta, slot_maps[m],
                                         pk, pv)
        pools["mirror"] = (pk, pv)
        pk, pv = _fresh_pools(handles, M * nb)
        for m, h in enumerate(handles):
            pk, pv = dense_restore_paged(h, cfg.rope_theta, slot_maps[m],
                                         pk, pv)
        pools["dense"] = (pk, pv)
        want = pools["dense"]
        for name in ("family", "mirror"):
            got = pools[name]
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), name
        for m, i in enumerate(mirrors):
            gk, gv = gather_pages(*pools["family"], slot_maps[m], g.S)
            assert torch.equal(gk, ks[i]) and torch.equal(gv, vs[i]), ids[i]
        log(f"fused family restore (1 launch) == fused per-mirror restore "
            f"({M} launches) == dense paged restore, and each mirror's "
            f"pages == its recovered KV: exact")
    else:
        slot_maps = np.zeros((0, 0), np.int32)
    return Walkthrough(g, res, ks, vs, master, handles, mirrors, st,
                       slot_maps, pools)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the tokens")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = init_params(cfg, args.seed, device=resolve_device(args.device))
    tokens = group_tokens(cfg.vocab_size, args.agents, priv_len=32,
                          block_len=128, seed=args.seed + 1)
    walkthrough(params, cfg, tokens, priv_len=32, ratio=0.05)


if __name__ == "__main__":
    main()
