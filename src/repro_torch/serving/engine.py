"""Round-synchronous multi-agent serving engine in PyTorch: a thin round
loop over a bound :class:`~repro_torch.serving.policies.base.ReusePolicy`
and a declarative gather topology.

Each round the engine (1) partitions agents into gather groups from the
topology (All-Gather = one group), then per group (2) asks the policy to
``plan`` (host-side; includes restores), (3) ``recover``, (4) runs the
greedy decode, and (5) asks the policy to ``store``.

Decode runs over round page pools (``paged_decode=True``, the default)
or over a dense ``[L, N, S+G]`` cache: the loop every SSM or hybrid model
takes (its state is not attention KV), and the bit-exact oracle the
paged loop is pinned against. An SSM or hybrid model is served with the
recompute policy whatever policy is asked for: PIC-style reuse does not
apply to SSM state.

The four registered policies share the model, the decode loop and the
accounting, so measured differences come from the reuse strategy:

  RecomputePolicy    — vLLM without reuse: full batched prefill a round
  PrefixCachePolicy  — vLLM + prefix caching: exact own-prefix reuse
  PICPolicy          — CacheBlend: per-request PIC recovery passes
  TokenDancePolicy   — the paper: collective recovery (one shared pass a
                       group) + Master-Mirror diffs + fused restore

The engine runs on the device of its parameters. ``run_round`` takes a
:class:`~repro_torch.serving.planner.RoundPlan` (admission subset and
topology override) and the next round's plan (restore-ahead prefetch);
``serve(trace, planner, n_rounds)`` asks a planner
(:class:`~repro_torch.serving.planner.RoundPlanner`, SLO admission) for
both. ``serving/loop`` drives the same pieces per committee
(``ContinuousEngine``). ``MultiAgentEngine(mode=...)`` remains as a
deprecated string-keyed shim.
"""
from __future__ import annotations

import itertools
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collector import KVCollector
from repro_torch.core.rounds import (AgentState, AllGather, AllGatherTrace,
                                     GatherTopology, Round, round_prompt)
from repro_torch.core.segments import PromptLayout, SegmentIndex
from repro_torch.models.transformer import decode_step, decode_step_paged
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.planner import RoundPlan
from repro_torch.serving.policies import (PolicyRuntime, ReusePolicy,
                                          RoundContext, get_policy)
from repro_torch.serving.policies.base import sync
from repro_torch.serving.pool import HostTier, PoolManager, parse_owner
from repro_torch.serving.state import RoundStats, Session

MODES = ("recompute", "prefix", "pic", "tokendance")
_SERIALS = itertools.count()


@dataclass
class DecodeState:
    """An in-flight greedy decode for one equal-length batch, advanced
    one model step at a time (begin -> advance x (G-1) -> finish)."""

    step: Callable                 # (tok, cache) -> (tok, cache)
    tok: torch.Tensor              # last greedy token, [N]
    cache: dict                    # dense or paged decode cache
    outs: list = field(default_factory=list)   # per-step tokens, [N] each
    gaids: List[str] = field(default_factory=list)
    S: int = 0                     # prompt length
    G: int = 0                     # gen_len
    bt: int = 0                    # block_tokens (page tile)
    paged: bool = False
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
        policy: Union[ReusePolicy, str] = "tokendance",
        *,
        topology: Optional[GatherTopology] = None,
        gen_len: int = 32,
        recompute_ratio: float = 0.15,
        block_select: int = 32,
        check_layer: int = 1,
        pool_pages: int = 1 << 16,
        eviction="family",
        host_offload: bool = True,
        paged_decode: bool = True,
        keep_recovered: bool = False,
        keep_logits: bool = False,
    ):
        if isinstance(policy, str):
            policy = get_policy(policy)
        if policy.requires_attention and (not cfg.has_attention
                                          or cfg.has_ssm):
            # PIC-style reuse is inapplicable to SSM/hybrid state; those
            # architectures serve via full recompute
            policy = get_policy("recompute")
        assert block_select == 0 or gen_len % block_select == 0, \
            "gen_len must be block-aligned so histories stay aligned"
        if block_select == 0 and policy.requires_blocks:
            # the JAX package raises ZeroDivisionError at round 1's plan
            raise ValueError(f"the {policy.name} policy selects KV blocks; "
                             f"it needs block_select > 0")
        if policy.requires_attention_cache and cfg.has_attention and \
                cfg.has_ssm:
            # the JAX package constructs and fails at round 1 (extend
            # asserts an attention-only cache); refuse before any work. An
            # attention-free model constructs, as in JAX: its rounds leave
            # no attention KV (round_kv is None), so the policy stores no
            # session and every round recomputes
            raise ValueError(f"the {policy.name} policy extends a cached "
                             f"attention prefix; {cfg.name} carries SSM "
                             f"state")
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
        # tiered layer over the pool: family-aware eviction + host
        # offload. host_offload=False gives the host tier capacity 0: a
        # full pool raises PoolExhausted as a plain pool does
        self.manager = PoolManager(
            self.pool, device=self.device, eviction=eviction,
            host=HostTier(None if host_offload else 0))
        # decode over round pool pages; False keeps the dense
        # [L, N, S+G] decode loop, the oracle the paged loop is pinned
        # against bit for bit
        self.paged_decode = paged_decode
        # keep each round's recovered KV (host copies) on last_recovered
        self.keep_recovered = keep_recovered
        self.last_recovered: Optional[tuple] = None
        self._recovered_parts: list = []
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
        self.mode = policy.name          # the JAX package's alias
        #: the first part of the request id of this engine's spans
        self.serial = next(_SERIALS)
        self.round_idx = 0
        self.last_outputs: Dict[str, np.ndarray] = {}
        #: owners the next round's restores read, still to prefetch
        self._prefetch_pending: List[str] = []

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
                      N: int, S: int, gaids: List[str],
                      use_paged: bool) -> DecodeState:
        """Build the decode cache and take the first greedy token from the
        recovery logits. Paged: the round pool holds each agent's sealed
        prefill pages, then zeroed gen pages. Dense: the prefill KV padded
        by G rows, and the SSM state as recovered. The cache is a fresh
        tensor owned by the returned state: decode steps write it in
        place."""
        cfg, G = self.cfg, self.gen_len
        bt = self.block_select
        if use_paged:
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
            }
            model_step = decode_step_paged
        else:
            cache = {key: F.pad(prefill_cache[key], (0, 0, 0, 0, 0, G))
                     for key in ("k", "v") if key in prefill_cache}
            cache.update({key: prefill_cache[key] for key in ("ssm", "conv")
                          if key in prefill_cache})
            model_step = decode_step
        cache["length"] = torch.full((N,), S, dtype=torch.int32,
                                     device=self.device)

        def step(tok, cache):
            logits, cache = model_step(self.params, cfg, tok, cache)
            return logits.argmax(dim=-1).to(torch.int32), cache

        tok = first_logits.argmax(dim=-1).to(torch.int32)
        return DecodeState(step=step, tok=tok, cache=cache, outs=[tok],
                           gaids=list(gaids), S=S, G=G, bt=bt,
                           paged=use_paged, t0=time.perf_counter())

    def _decode_advance(self, st: DecodeState) -> None:
        """One greedy decode step. On the paged path, the write at
        position S+t opens a fresh gen page each time generation crosses a
        block boundary: claim it in the ledger before the step fills its
        first slot."""
        if st.paged and (st.S + st.t) % st.bt == 0:
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

    def _paged_decode_ok(self, prefill_cache: dict, S: int) -> bool:
        """The paged loop carries attention KV only and needs the page
        tile to line up with the prompt and generation lengths."""
        bt = self.block_select
        return (self.paged_decode and bt > 0
                and "k" in prefill_cache
                and "ssm" not in prefill_cache
                and "conv" not in prefill_cache
                and S % bt == 0 and self.gen_len % bt == 0)

    def _decode(self, first_logits, prefill_cache: dict, N: int, S: int,
                gaids: List[str], use_paged: bool):
        """Greedy decode of G tokens. Paged: the KV lives in round pool
        pages — the recovered prefill KV becomes each agent's sealed pages
        and every generated token is written into its open gen page.
        Dense: a padded ``[L, N, S+G]`` cache (attention KV, SSM state, or
        both) — the loop of SSM/hybrid models and the bit-exact oracle of
        the paged loop."""
        with spans.span("engine.decode", timed=True) as sp:
            with spans.span("engine.decode.begin"):
                st = self._decode_begin(first_logits, prefill_cache, N, S,
                                        gaids, use_paged)
            while not st.done:
                with spans.span("engine.decode.step", self.device, t=st.t):
                    self._decode_advance(st)
            with spans.span("engine.decode.finish"):
                outs, cache, _ = self._decode_finish(st)
        return outs, cache, sp.host_s

    # ------------------------------------------------------------------
    def run_round(self, rnd: Round, plan: Optional[RoundPlan] = None,
                  next_plan: Optional[RoundPlan] = None) -> RoundStats:
        """Serve one round. ``plan`` restricts it to the admitted agents
        (the others keep their sessions; their last outputs stay in the
        gather) and may override the topology; ``next_plan``, the
        following round's admission, names the owners whose reload from
        the host tier can overlap this round's decode."""
        with spans.span("engine.round", engine=self.serial,
                        round=self.round_idx):
            return self._run_round(rnd, plan, next_plan)

    def _run_round(self, rnd: Round, plan: Optional[RoundPlan],
                   next_plan: Optional[RoundPlan]) -> RoundStats:
        # generate mode: previous outputs are this round's shared blocks;
        # an agent with no output yet (deferred since round 0) contributes
        # its trace block instead
        if self.round_idx > 0 and self.last_outputs:
            fallback = self._replay_fallback_blocks(rnd)
            shared = []
            for a in self.sessions:
                prev = self.last_outputs.get(a, fallback.get(a))
                assert prev is not None, f"no output block for agent {a}"
                shared.append(prev)
            rnd = Round(rnd.index, shared, rnd.tasks)
        all_ids = list(self.sessions)
        admitted = (all_ids if plan is None
                    else [a for a in plan.admitted if a in self.sessions])
        topology = (plan.topology if plan is not None and plan.topology
                    else self.topology)
        self.manager.begin_round(self.round_idx)
        ledger_before = self.manager.ledger.snapshot()
        scoped_before = self.manager.ledger.scoped_snapshot()
        # restore-ahead: round r+1's admission names the owners its
        # restores will read; agents admitted THIS round are excluded
        # (this round's store re-forms their family state anyway)
        self._prefetch_pending = (
            [] if next_plan is None else
            self.manager.prefetch_planner.owners_for(
                self.sessions, next_plan.admitted, exclude=admitted))
        stats = RoundStats(self.round_idx, self.policy.name, len(admitted), 0)
        if plan is not None:
            stats.admission = {
                "max_agents": plan.max_agents,
                "admitted": list(plan.admitted),
                "deferred": list(plan.deferred),
            }
        groups = (topology.gather_groups(all_ids, admitted)
                  if admitted else [])
        out_rows: Dict[str, np.ndarray] = {}
        logit_rows: Dict[str, np.ndarray] = {}
        sources = topology.sources(all_ids)
        if self.keep_recovered:
            self._recovered_parts = []
        for gi, gaids in enumerate(groups):
            parts = self._build_prompts(rnd, gaids, sources)
            for pj, (paids, tokens_np, layouts) in enumerate(parts):
                gid = f"g{gi}" if len(parts) == 1 else f"g{gi}.{pj}"
                with self.manager.scoped(gid.split(".")[0]), spans.span(
                        "engine.batch", gid=gid, N=len(paids),
                        S=tokens_np.shape[1]):
                    rows = self._run_group(gid, paids, tokens_np, layouts,
                                           stats)
                for a, row, lg in rows:
                    out_rows[a] = row
                    logit_rows[a] = lg
        if admitted:
            stats.outputs = np.stack([out_rows[a] for a in admitted])
            if self.keep_logits:
                stats.first_logits = np.stack(
                    [logit_rows[a] for a in admitted])
        if self.keep_recovered and self._recovered_parts:
            # one batch (the All-Gather norm): the (k, v, layouts) tuple;
            # several batches: one tuple a batch
            self.last_recovered = (self._recovered_parts[0]
                                   if len(self._recovered_parts) == 1
                                   else self._recovered_parts)
        stats.transient_peak_bytes = self.pool.peak_bytes()
        self.manager.free_transient()
        if self._prefetch_pending:   # retry now that transients are free
            self.manager.prefetch(self._prefetch_pending)
            self._prefetch_pending = []
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
        with spans.span("policy.plan"):
            rplan = self.policy.plan(ctx)
        res = self.policy.recover(rplan, tokens)
        stats.t_recover += res.t_recover
        stats.t_restore += rplan.t_restore
        for k_, v_ in res.info.items():
            if k_ != "plan":
                stats.merge_reuse(k_, v_)
        if rplan.restore_info is not None:
            stats.merge_reuse("restore", rplan.restore_info)
        if self.keep_recovered and "k" in res.cache:
            self._recovered_parts.append(
                (res.cache["k"].cpu(), res.cache["v"].cpu(), list(layouts)))

        # transient working set: the restore pool claimed during plan()
        # is reclaimed here, after its peak registered. Dense decode
        # claims the full S+G tokens up front; paged decode claims the S
        # prefill tokens and grows one page per block boundary
        # (append_page), reaching the same S+G total by round end
        use_paged = self._paged_decode_ok(res.cache, S)
        self.manager.free_transient()
        for a in gaids:
            self.manager.free(f"round:{a}")
            self.manager.alloc_tokens(
                f"round:{a}", S if use_paged else S + self.gen_len,
                persistent=False)

        # restore-ahead prefetch for the next round, beside this decode
        # (the first group to get here issues it; owners that do not fit
        # beside the live transients are retried at round end)
        if self._prefetch_pending:
            self._prefetch_pending = self.manager.prefetch(
                self._prefetch_pending)

        # ---- decode -------------------------------------------------------
        outputs, cache, dt_dec = self._decode(res.logits, res.cache, N, S,
                                              gaids, use_paged)
        stats.t_decode += dt_dec

        # ---- store --------------------------------------------------------
        with spans.span("policy.store", timed=True) as sp:
            for i, a in enumerate(gaids):
                self.sessions[a].state.extend_history(outputs[i])
                self.last_outputs[a] = outputs[i]
            self.policy.store(ctx, cache, outputs, res, stats)
            sync(self.device)
        stats.t_store += sp.host_s
        logits_np = (res.logits.float().cpu().numpy() if self.keep_logits
                     else [None] * N)
        return [(a, outputs[i], logits_np[i]) for i, a in enumerate(gaids)]

    # ------------------------------------------------------------------
    def _replay_fallback_blocks(self, rnd: Round) -> Dict[str, np.ndarray]:
        """Trace blocks keyed by agent id, for agents with no output yet
        in generate mode (``rnd.tasks`` keeps the trace's agent order, so
        block j belongs to agent j)."""
        return dict(zip(rnd.tasks, list(rnd.shared_blocks)))

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

    def _persistent_bytes(self) -> int:
        """Persistent bytes on the device and the host tier together (the
        restore cache excluded), as ``RoundStats.persistent_bytes``."""
        dev, host, _ = self._persistent_split()
        return dev + host

    # ------------------------------------------------------------------
    def serve(self, trace: AllGatherTrace, planner=None,
              n_rounds: Optional[int] = None) -> List[RoundStats]:
        """Serve a trace: one :meth:`run_round` per round, each preceded
        by the planner's admission decision (admit-all when absent).

        ``planner`` is any object with ``plan_round(round_idx, agent_ids)
        -> RoundPlan`` and ``observe(stats, collective=...)``, as the JAX
        package's ``RoundPlanner``; the arguments keep the JAX order
        ``(trace, planner, n_rounds)``. The plan for round r+1 is made
        while round r is current and handed to :meth:`run_round` as
        ``next_plan`` (restore-ahead prefetch); round r's stats reach
        ``observe`` after that lookahead plan exists.
        """
        if not self.sessions:
            self.init_agents(trace)
        rounds = trace.rounds[: n_rounds or len(trace.rounds)]
        out = []
        plan = (None if planner is None or not rounds else
                planner.plan_round(self.round_idx, list(self.sessions)))
        for i, rnd in enumerate(rounds):
            next_plan = (None if planner is None or i + 1 >= len(rounds) else
                         planner.plan_round(self.round_idx + 1,
                                            list(self.sessions)))
            stats = self.run_round(rnd, plan, next_plan=next_plan)
            out.append(stats)
            if planner is not None:
                collective = getattr(self.policy, "collective",
                                     self.policy.name == "tokendance")
                planner.observe(stats, collective=collective)
            plan = next_plan
        return out

    def run_trace(self, trace: AllGatherTrace,
                  n_rounds: Optional[int] = None) -> List[RoundStats]:
        """:meth:`serve` without a planner."""
        return self.serve(trace, n_rounds=n_rounds)


class MultiAgentEngine(ServingEngine):
    """Deprecated mode-string front door, kept for compatibility.

    ``MultiAgentEngine(params, cfg, "tokendance")`` resolves the mode
    string through the policy registry and behaves bit-exactly like
    ``ServingEngine(params, cfg, TokenDancePolicy())``. New code should
    construct a policy object."""

    def __init__(self, params: dict, cfg: ModelConfig, mode: str, *,
                 paged_history: bool = True, paged_attention: bool = True,
                 incremental: bool = True, **kw):
        warnings.warn(
            "MultiAgentEngine(mode=...) is deprecated; pass a ReusePolicy "
            "to ServingEngine (e.g. ServingEngine(params, cfg, "
            "TokenDancePolicy())) instead.",
            DeprecationWarning, stacklevel=2)
        policy_kw = ({"paged_history": paged_history,
                      "paged_attention": paged_attention,
                      "incremental": incremental}
                     if mode == "tokendance" else {})
        super().__init__(params, cfg, get_policy(mode, **policy_kw), **kw)
