"""Round-synchronous multi-agent serving engine in PyTorch: a thin round
loop over a bound :class:`~repro_torch.serving.policies.base.ReusePolicy`
and a declarative gather topology.

Each round the engine (1) partitions agents into gather groups from the
topology (All-Gather = one group), then per group (2) asks the policy to
``plan`` (host-side; includes restores), (3) ``recover``, (4) runs the
greedy decode over page pools, and (5) asks the policy to ``store``.

The engine runs on the device of its parameters. Decode is always paged
(the dense decode oracle, the admission planner and the continuous
engine of the JAX package are not ported yet).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collector import KVCollector
from repro_torch.core.rounds import (AgentState, AllGather, AllGatherTrace,
                                     GatherTopology, Round, round_prompt)
from repro_torch.core.segments import PromptLayout, SegmentIndex
from repro_torch.models.layers import check_supported
from repro_torch.models.transformer import decode_step_paged
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.policies.base import (PolicyRuntime, ReusePolicy,
                                               RoundContext, sync)
from repro_torch.serving.pool import PoolManager, parse_owner
from repro_torch.serving.state import RoundStats, Session


@dataclass
class DecodeState:
    """An in-flight greedy decode for one equal-length batch, advanced
    one model step at a time (begin -> advance x (G-1) -> finish)."""

    step: Callable                 # (tok, cache) -> (tok, cache)
    tok: torch.Tensor              # last greedy token, [N]
    cache: dict                    # paged decode cache
    outs: list = field(default_factory=list)   # per-step tokens, [N] each
    gaids: List[str] = field(default_factory=list)
    S: int = 0                     # prompt length
    G: int = 0                     # gen_len
    bt: int = 0                    # block_tokens (page tile)
    t: int = 0                     # decode steps taken (of G-1)
    t0: float = 0.0

    @property
    def done(self) -> bool:
        return self.t >= self.G - 1


class ServingEngine:
    """Thin round loop over one bound :class:`ReusePolicy`."""

    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        policy: ReusePolicy,
        *,
        topology: Optional[GatherTopology] = None,
        gen_len: int = 32,
        recompute_ratio: float = 0.15,
        block_select: int = 32,
        check_layer: int = 1,
        pool_pages: int = 1 << 16,
        keep_logits: bool = False,
    ):
        check_supported(cfg)
        assert block_select > 0 and gen_len % block_select == 0, \
            "gen_len must be block-aligned so histories stay aligned"
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.gen_len = gen_len
        self.block_select = block_select
        self.sep_id = cfg.vocab_size - 1
        self.topology = topology or AllGather()
        self.sessions: Dict[str, Session] = {}
        self.segment_index = SegmentIndex()
        self.pool = PagedKVPool(cfg, pool_pages)
        # tiered layer over the pool: family-aware eviction + an
        # unbounded host tier
        self.manager = PoolManager(self.pool, device=self.device)
        # record per-round first-token logits on RoundStats (host copy of
        # [N, vocab] per round — parity-test food, off by default)
        self.keep_logits = keep_logits
        self.collector = KVCollector(
            params, cfg, check_layer=check_layer,
            recompute_ratio=recompute_ratio, block_select=block_select)
        self.rt = PolicyRuntime(
            params=params, cfg=cfg, gen_len=gen_len, ratio=recompute_ratio,
            block_select=block_select, sep_id=self.sep_id,
            sessions=self.sessions, segment_index=self.segment_index,
            pool=self.pool, collector=self.collector, manager=self.manager,
            device=self.device)
        policy.bind(self.rt)
        self.policy = policy
        self.round_idx = 0
        self.last_outputs: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def init_agents(self, trace: AllGatherTrace) -> None:
        for aid in trace.agent_ids:
            self.sessions[aid] = Session(
                aid, AgentState(aid, np.asarray(trace.init_histories[aid])))

    def _build_prompts(
        self, rnd: Round, gaids: List[str],
        sources: Dict[str, Tuple[int, ...]],
    ) -> List[Tuple[List[str], np.ndarray, List[PromptLayout]]]:
        """Prompts for one gather group, partitioned into equal-length
        batches (members share a layout; histories of different length
        split into separate batches)."""
        shared = rnd.shared_blocks
        parts: Dict[int, list] = {}
        for aid in gaids:
            if shared:
                bad = [j for j in sources[aid] if j >= len(shared)]
                assert not bad, (
                    f"topology sources {bad} for {aid} out of range for "
                    f"{len(shared)} shared blocks")
                order = list(sources[aid])
            else:
                order = []      # round 0: no output blocks yet
            lay = round_prompt(self.sessions[aid].state, shared,
                               rnd.tasks[aid], self.sep_id,
                               layout_order=order,
                               align_blocks=self.block_select)
            parts.setdefault(lay.tokens.shape[0], []).append((aid, lay))
        return [([a for a, _ in p], np.stack([l.tokens for _, l in p]),
                 [l for _, l in p]) for p in parts.values()]

    # ------------------------------------------------------------------
    def _decode_begin(self, first_logits: torch.Tensor, prefill_cache: dict,
                      N: int, S: int, gaids: List[str]) -> DecodeState:
        """Build the round pool from the recovered prefill KV (each
        agent's sealed pages, then zeroed gen pages), take the first
        greedy token from the recovery logits. The pool is a fresh tensor
        owned by the returned state: decode steps write it in place."""
        cfg, G = self.cfg, self.gen_len
        bt = self.block_select
        nb_s, nb_g = S // bt, G // bt
        nbt = nb_s + nb_g
        k, v = prefill_cache["k"], prefill_cache["v"]
        L, _, _, KV, hd = k.shape

        def to_pool(x):
            x = x.reshape(L, N, nb_s, bt, KV, hd)
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, nb_g))
            return x.reshape(L, N * nbt, bt, KV, hd)

        cache = {
            "pk": to_pool(k),
            "pv": to_pool(v),
            "page_idx": torch.arange(N * nbt, dtype=torch.int32,
                                     device=self.device).reshape(N, nbt),
            "length": torch.full((N,), S, dtype=torch.int32,
                                 device=self.device),
        }

        def step(tok, cache):
            logits, cache = decode_step_paged(self.params, cfg, tok, cache)
            return logits.argmax(dim=-1).to(torch.int32), cache

        tok = first_logits.argmax(dim=-1).to(torch.int32)
        return DecodeState(step=step, tok=tok, cache=cache, outs=[tok],
                           gaids=list(gaids), S=S, G=G, bt=bt,
                           t0=time.perf_counter())

    def _decode_advance(self, st: DecodeState) -> None:
        """One greedy decode step. The write at position S+t opens a fresh
        gen page each time generation crosses a block boundary: claim it
        in the ledger before the step fills its first slot."""
        if (st.S + st.t) % st.bt == 0:
            for a in st.gaids:
                self.manager.append_page(f"round:{a}")
        st.tok, st.cache = st.step(st.tok, st.cache)
        st.outs.append(st.tok)
        st.t += 1

    def _decode_finish(self, st: DecodeState):
        """Outputs [N, G] on the host, the final cache, and the wall-clock
        since :meth:`_decode_begin`."""
        outs = torch.stack(st.outs, dim=1).cpu().numpy()
        sync(self.device)
        return outs, st.cache, time.perf_counter() - st.t0

    def _decode_paged(self, first_logits, prefill_cache: dict, N: int,
                      S: int, gaids: List[str]):
        """Greedy decode whose KV lives in round pool pages: the recovered
        prefill KV becomes each agent's sealed pages and every generated
        token is written into its open gen page."""
        bt = self.block_select
        if S % bt or self.gen_len % bt or "k" not in prefill_cache:
            raise NotImplementedError(
                "the dense decode loop is not ported; paged decode needs "
                "block-aligned prompt and generation lengths")
        st = self._decode_begin(first_logits, prefill_cache, N, S, gaids)
        while not st.done:
            self._decode_advance(st)
        return self._decode_finish(st)

    # ------------------------------------------------------------------
    def run_round(self, rnd: Round) -> RoundStats:
        # generate mode: previous outputs are this round's shared blocks
        if self.round_idx > 0 and self.last_outputs:
            rnd = Round(rnd.index, [self.last_outputs[a]
                                    for a in self.sessions], rnd.tasks)
        all_ids = list(self.sessions)
        self.manager.begin_round(self.round_idx)
        ledger_before = self.manager.ledger.snapshot()
        scoped_before = self.manager.ledger.scoped_snapshot()
        stats = RoundStats(self.round_idx, self.policy.name, len(all_ids), 0)
        out_rows: Dict[str, np.ndarray] = {}
        logit_rows: Dict[str, np.ndarray] = {}
        sources = self.topology.sources(all_ids)
        for gi, gaids in enumerate(self.topology.gather_groups(all_ids)):
            parts = self._build_prompts(rnd, gaids, sources)
            for pj, (paids, tokens_np, layouts) in enumerate(parts):
                gid = f"g{gi}" if len(parts) == 1 else f"g{gi}.{pj}"
                with self.manager.scoped(gid.split(".")[0]):
                    rows = self._run_group(gid, paids, tokens_np, layouts,
                                           stats)
                for a, row, lg in rows:
                    out_rows[a] = row
                    logit_rows[a] = lg
        stats.outputs = np.stack([out_rows[a] for a in all_ids])
        if self.keep_logits:
            stats.first_logits = np.stack([logit_rows[a] for a in all_ids])
        stats.transient_peak_bytes = self.pool.peak_bytes()
        self.manager.free_transient()
        dev_bytes, host_bytes, cache_bytes = self._persistent_split()
        stats.persistent_bytes = dev_bytes + host_bytes
        pool_delta = self.manager.ledger.delta(ledger_before)
        # per-committee breakdown of the same counters (scope = gather
        # group id; traffic outside any group books to "engine")
        by_committee = self.manager.ledger.scoped_delta(scoped_before)
        if by_committee:
            pool_delta["by_committee"] = by_committee
        pool_delta["persistent_device_bytes"] = dev_bytes
        pool_delta["persistent_host_bytes"] = host_bytes
        pool_delta["restore_cache_bytes"] = cache_bytes
        stats.merge_reuse("pool", pool_delta)
        self.round_idx += 1
        return stats

    def _run_group(self, gid: str, gaids: List[str], tokens_np: np.ndarray,
                   layouts: List[PromptLayout], stats: RoundStats):
        """plan -> recover -> decode -> store for one equal-length batch
        of a gather group."""
        tokens = torch.as_tensor(tokens_np, device=self.device)
        N, S = tokens.shape
        if stats.prompt_len == 0:
            stats.prompt_len = S
        ctx = RoundContext(round_idx=self.round_idx, gid=gid,
                           agent_ids=list(gaids), layouts=layouts,
                           tokens=tokens_np)

        # ---- plan (host, restores) + recover ----------------------------
        rplan = self.policy.plan(ctx)
        res = self.policy.recover(rplan, tokens)
        stats.t_recover += res.t_recover
        stats.t_restore += rplan.t_restore
        for k_, v_ in res.info.items():
            if k_ != "plan":
                stats.merge_reuse(k_, v_)
        if rplan.restore_info is not None:
            stats.merge_reuse("restore", rplan.restore_info)

        # transient working set: the restore pool claimed during plan()
        # is reclaimed here, after its peak registered; paged decode
        # claims the S prefill tokens and grows one page per block
        # boundary (append_page), reaching S+G by round end
        self.manager.free_transient()
        for a in gaids:
            self.manager.free(f"round:{a}")
            self.manager.alloc_tokens(f"round:{a}", S, persistent=False)

        # ---- decode -------------------------------------------------------
        outputs, cache, dt_dec = self._decode_paged(res.logits, res.cache, N,
                                                    S, gaids)
        stats.t_decode += dt_dec

        # ---- store --------------------------------------------------------
        t0 = time.perf_counter()
        for i, a in enumerate(gaids):
            self.sessions[a].state.extend_history(outputs[i])
            self.last_outputs[a] = outputs[i]
        self.policy.store(ctx, cache, outputs, res, stats)
        sync(self.device)
        stats.t_store += time.perf_counter() - t0
        logits_np = (res.logits.float().cpu().numpy() if self.keep_logits
                     else [None] * N)
        return [(a, outputs[i], logits_np[i]) for i, a in enumerate(gaids)]

    # ------------------------------------------------------------------
    def _persistent_split(self) -> Tuple[int, int, int]:
        """Footprint per class: (device_bytes, host_bytes, cache_bytes).
        Spilled persistent entries still count (the spill moved bytes, it
        didn't drop them). ``hist:family:`` owners — a reconstructible
        restore cache — book to cache_bytes."""
        dev = cache = host = 0
        pb = self.pool.page_bytes()
        for owner in self.pool.owners():
            a = self.pool._allocs[owner]
            if not a.persistent:
                continue
            if parse_owner(owner).kind == "histpool":
                cache += a.n_pages * pb
            else:
                dev += a.n_pages * pb
        for owner, e in self.manager.host._entries.items():
            if not e.persistent:
                continue
            if parse_owner(owner).kind == "histpool":
                cache += e.n_pages * pb
            else:
                host += e.n_pages * pb
        return dev, host, cache

    # ------------------------------------------------------------------
    def serve(self, trace: AllGatherTrace,
              n_rounds: Optional[int] = None) -> List[RoundStats]:
        """Serve a trace: one :meth:`run_round` per round."""
        if not self.sessions:
            self.init_agents(trace)
        return [self.run_round(rnd)
                for rnd in trace.rounds[: n_rounds or len(trace.rounds)]]
