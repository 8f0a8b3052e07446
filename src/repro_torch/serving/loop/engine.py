"""Continuous serving engine: phase-level scheduling over committees.

``ContinuousEngine`` wraps a synchronized :class:`ServingEngine` and
re-drives its pieces — policy ``plan``/``recover``/``store``, the
begin/advance/finish decode split, the pool manager — from
:class:`StepScheduler` work items instead of a global round loop.
Committees (disjoint gather groups of a ``SubsetGather.grouped``
topology) proceed through their rounds independently: committee A's
restore for round r+1 executes while committee B's round-r decode holds
the virtual clock, per-agent tokens are stamped with the tick that
produced them, and admission (:class:`RoundPlanner`) plus restore-ahead
prefetch plug in per committee-round.

Bit-exactness contract (the oracle relationship, pinned in tests): the
continuous engine performs exactly the synchronized engine's
computations — same prompt construction, same policy calls with the
same ``RoundContext``, same step functions and shapes, same decode step
sequence per committee — merely interleaved across committees. The
policies' untimed first call of a new shape (``PolicyRuntime.timed``)
is shared across committees, so the first committee to reach a shape
pays it; it repeats the same computation, so no output or ledger
depends on which committee that was. Committees are computationally
independent (disjoint sessions, disjoint Master families; a committee's
prompts read only its own members' output blocks), and the pool's
spill/reload seam is bit-exact by construction, so interleaving cannot
change any output.
On a single-committee trace the schedules coincide call for call and
outputs AND logits match the synchronized ``serve()`` bit for bit.

What "one global decode batch" means here: DECODE-phase committees step
on the same tick, each through its own step function (the same
functions, with the same shapes, the synchronized engine uses). Fusing
different committees into one physical batch would change the kernels'
shapes and risk numeric drift — the slot budget models the shared
capacity; the per-committee sub-batches keep the oracle exact.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rounds import AllGatherTrace, GatherTopology, Round
from repro_torch.serving.engine import DecodeState, ServingEngine
from repro_torch.serving.loop.scheduler import StepEvent, StepScheduler
from repro_torch.serving.loop.workitem import Phase, PhaseCost, WorkItem
from repro_torch.serving.planner import RoundPlanner
from repro_torch.serving.policies import ReusePolicy, RoundContext
from repro_torch.serving.state import RoundStats


@dataclass
class ContinuousResult:
    """What a continuous serve produced, in counted model-step slots.

    ``stats[c][r]`` mirrors the synchronized engine's per-round
    :class:`RoundStats`, one list per committee. ``outputs[aid]`` /
    ``logits[aid]`` collect each agent's per-served-round rows (logits
    only when the engine keeps them). ``token_ticks[aid][i]`` is the
    list of virtual ticks at which that agent's i-th served round
    produced each of its G tokens — the streaming face: token j exists
    (and is observable via ``on_token``) as of that tick, not at the
    round barrier.
    """

    stats: Dict[int, List[RoundStats]]
    outputs: Dict[str, List[np.ndarray]]
    logits: Dict[str, List[Optional[np.ndarray]]]
    token_ticks: Dict[str, List[List[int]]]
    makespan_steps: int
    sync_makespan_steps: int
    overlap_steps: int
    #: RESTORE/PREFILL phase_begins that executed while another
    #: committee's decode was mid-flight (the spy-test counter)
    restore_overlap_events: int
    timeline: List[StepEvent] = field(default_factory=list)


class ContinuousEngine:
    """Phase-level continuous serving over a wrapped synchronized engine.

    Constructor arguments mirror :class:`ServingEngine` (policy object
    or registry name, topology, engine knobs); ``slots_per_step`` sets
    the virtual model step's batch capacity in token slots (default:
    twice the fleet size, so a decoding fleet still leaves headroom for
    another committee's restore/prefill to drain).
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 policy: Union[ReusePolicy, str] = "tokendance", *,
                 topology: Optional[GatherTopology] = None,
                 slots_per_step: Optional[int] = None,
                 **engine_kw):
        self.engine = ServingEngine(params, cfg, policy,
                                    topology=topology, **engine_kw)
        self.slots_per_step = slots_per_step
        self.scheduler: Optional[StepScheduler] = None
        self._on_token = None
        # per-serve state
        self._committees: List[List[str]] = []
        self._sources: Dict[str, tuple] = {}
        self._rounds: List[Round] = []
        self._planner: Optional[RoundPlanner] = None
        self._next_plans: Dict[tuple, object] = {}
        self._epoch = 0
        self._restore_overlap = 0
        self._result: Optional[ContinuousResult] = None

    # ------------------------------------------------------------- serve
    def serve(self, trace: AllGatherTrace,
              planner: Optional[RoundPlanner] = None,
              n_rounds: Optional[int] = None,
              stagger: Optional[Sequence[int]] = None,
              on_token=None) -> ContinuousResult:
        """Serve a trace continuously.

        ``stagger`` gives each committee's arrival tick (default: all at
        0 — committees still overlap whenever their phase mix allows).
        ``planner`` admission runs per committee-round over that
        committee's members; plan-ahead and ``observe`` feedback keep
        the synchronized engine's one-round-lookahead semantics.
        ``on_token(agent_id, round_idx, step, token, tick)`` streams
        tokens as they are produced (forces a per-step host sync — leave
        unset for pure throughput runs; ``token_ticks`` records arrival
        ticks either way).
        """
        eng = self.engine
        if not eng.sessions:
            eng.init_agents(trace)
        all_ids = list(eng.sessions)
        self._committees = eng.topology.gather_groups(all_ids)
        self._sources = eng.topology.sources(all_ids)
        self._rounds = list(trace.rounds[: n_rounds or len(trace.rounds)])
        self._planner = planner
        self._next_plans = {}
        self._epoch = 0
        self._restore_overlap = 0
        self._on_token = on_token
        n_c = len(self._committees)
        # the continuous begin_round clock ticks once per committee-round
        # start; a one-round prefetch lookahead therefore spans up to
        # n_committees epochs
        eng.manager.prefetch_ttl = max(1, n_c)
        slots = self.slots_per_step
        if slots is None:
            slots = max(8, 2 * len(all_ids))
        max_committee = max((len(c) for c in self._committees), default=1)
        assert slots >= max_committee, (
            f"slots_per_step={slots} cannot fit one decode step of the "
            f"largest committee ({max_committee} agents)")
        stats: Dict[int, List[RoundStats]] = {c: [] for c in range(n_c)}
        outputs: Dict[str, List[np.ndarray]] = {a: [] for a in all_ids}
        logits: Dict[str, List[Optional[np.ndarray]]] = \
            {a: [] for a in all_ids}
        token_ticks: Dict[str, List[List[int]]] = {a: [] for a in all_ids}
        self._result = ContinuousResult(
            stats=stats, outputs=outputs, logits=logits,
            token_ticks=token_ticks, makespan_steps=0,
            sync_makespan_steps=0, overlap_steps=0,
            restore_overlap_events=0)
        # the scheduler calls back through a weak proxy: a strong
        # reference would make engine <-> scheduler a cycle that keeps the
        # weights alive after ``del`` until the collector runs
        self.scheduler = StepScheduler(
            weakref.proxy(self), n_c, len(self._rounds),
            slots_per_step=slots, arrivals=stagger)
        makespan = self.scheduler.run()
        res = self._result
        res.makespan_steps = makespan
        res.sync_makespan_steps = self.scheduler.sync_makespan()
        res.overlap_steps = self.scheduler.overlap_steps()
        res.restore_overlap_events = self._restore_overlap
        res.timeline = self.scheduler.timeline
        return res

    # -------------------------------------------------- executor protocol
    def phase_begin(self, item: WorkItem) -> PhaseCost:
        c, r = item.committee, item.round_idx
        with self.engine.manager.scoped(f"g{c}"):
            if item.phase == Phase.PLAN:
                return self._begin_plan(item, c, r)
            if item.phase == Phase.RESTORE:
                self._note_overlap(c)
                return self._begin_restore(item, c, r)
            if item.phase == Phase.PREFILL:
                self._note_overlap(c)
                return self._begin_prefill(item, c, r)
            if item.phase == Phase.DECODE:
                return self._begin_decode(item, c, r)
            assert item.phase == Phase.STORE
            return self._begin_store(item, c, r)

    def run_units(self, item: WorkItem, k: int, tick: int) -> None:
        if item.phase != Phase.DECODE:
            return                      # restore/prefill drain is accounting
        eng = self.engine
        with eng.manager.scoped(f"g{item.committee}"):
            for _ in range(k):
                for part in item.data["parts"]:
                    st: DecodeState = part["decode"]
                    eng._decode_advance(st)
                    self._stream_tokens(part, st, item.round_idx, tick)

    def phase_end(self, item: WorkItem, tick: int) -> None:
        if item.phase == Phase.PREFILL:
            # the first greedy token comes from the recovery logits —
            # it exists as of the prefill's completion tick
            for part in item.data["parts"]:
                for a in part["aids"]:
                    part["ticks"][a] = [tick]

    # ------------------------------------------------------------- phases
    def _begin_plan(self, item: WorkItem, c: int, r: int) -> PhaseCost:
        eng = self.engine
        members = self._committees[c]
        eng.manager.begin_round(self._epoch)
        self._epoch += 1
        plan = self._next_plans.pop((c, r), None)
        if plan is None and self._planner is not None:
            plan = self._planner.plan_round(r, list(members))
        assert plan is None or plan.topology is None, (
            "per-round topology overrides would re-form committees "
            "mid-flight; the continuous engine does not support them")
        admitted = (list(members) if plan is None
                    else [a for a in plan.admitted if a in eng.sessions])
        rnd = self._committee_round(r)
        parts = []
        if admitted:
            built = eng._build_prompts(rnd, admitted, self._sources)
            for pj, (paids, tokens_np, layouts) in enumerate(built):
                gid = f"g{c}" if len(built) == 1 else f"g{c}.{pj}"
                parts.append({"gid": gid, "aids": paids,
                              "tokens": tokens_np, "layouts": layouts,
                              "ticks": {a: [] for a in paids}})
        stats = RoundStats(r, eng.policy.name, len(admitted),
                           parts[0]["tokens"].shape[1] if parts else 0)
        if plan is not None:
            stats.admission = {
                "max_agents": plan.max_agents,
                "admitted": list(plan.admitted),
                "deferred": list(plan.deferred),
            }
        item.data.update(
            plan=plan, admitted=admitted, parts=parts, stats=stats,
            scoped_before=eng.manager.ledger.scoped_snapshot(),
            prefetch_pending=[])
        return PhaseCost(0)

    def _begin_restore(self, item: WorkItem, c: int, r: int) -> PhaseCost:
        eng = self.engine
        stats: RoundStats = item.data["stats"]
        units = 0
        for part in item.data["parts"]:
            ctx = RoundContext(round_idx=r, gid=part["gid"],
                               agent_ids=list(part["aids"]),
                               layouts=part["layouts"],
                               tokens=part["tokens"])
            rplan = eng.policy.plan(ctx)
            part["ctx"], part["rplan"] = ctx, rplan
            stats.t_restore += rplan.t_restore
            units += self._restore_units(rplan.restore_info)
        return PhaseCost(units)

    def _restore_units(self, info) -> int:
        """Counted restore work in token-slots: pages written × page
        tile. Dense (non-paged) restores report no page count and are
        host-side gathers — zero model-step cost, like the synchronized
        engine's accounting."""
        if info is None:
            return 0
        infos = info if isinstance(info, list) else [info]
        bt = max(1, self.engine.block_select)
        return sum(int(i.get("pool_pages", 0)) * bt
                   for i in infos if isinstance(i, dict))

    def _begin_prefill(self, item: WorkItem, c: int, r: int) -> PhaseCost:
        eng = self.engine
        stats: RoundStats = item.data["stats"]
        units = 0
        for part in item.data["parts"]:
            rplan = part["rplan"]
            tokens = torch.as_tensor(part["tokens"], device=eng.device)
            res = eng.policy.recover(rplan, tokens)
            part["res"] = res
            stats.t_recover += res.t_recover
            for k_, v_ in res.info.items():
                if k_ != "plan":
                    stats.merge_reuse(k_, v_)
            if rplan.restore_info is not None:
                stats.merge_reuse("restore", rplan.restore_info)
            N, S = part["tokens"].shape
            units += N * S
        # the committee's restore-pool transients were consumed by the
        # recovery pass; reclaim them (and stale round buffers) WITHOUT
        # touching other committees' in-flight working sets, then claim
        # this round's decode buffers
        self._free_committee_transients(c, item.data["admitted"])
        for part in item.data["parts"]:
            N, S = part["tokens"].shape
            part["use_paged"] = eng._paged_decode_ok(part["res"].cache, S)
            for a in part["aids"]:
                eng.manager.alloc_tokens(
                    f"round:{a}",
                    S if part["use_paged"] else S + eng.gen_len,
                    persistent=False)
        return PhaseCost(units)

    def _begin_decode(self, item: WorkItem, c: int, r: int) -> PhaseCost:
        eng = self.engine
        n_agents = 0
        for part in item.data["parts"]:
            N, S = part["tokens"].shape
            res = part["res"]
            part["decode"] = eng._decode_begin(
                res.logits, res.cache, N, S, part["aids"],
                part["use_paged"])
            n_agents += N
        # restore-ahead prefetch for this committee's round r+1, issued
        # per-phase: it overlaps THIS committee's decode ticks (and any
        # other committee's work) instead of waiting for a round barrier
        item.data["prefetch_pending"] = self._issue_prefetch(item, c, r)
        if not item.data["parts"]:
            return PhaseCost(0)
        return PhaseCost(max(0, eng.gen_len - 1),
                         unit_slots=max(1, n_agents), per_tick=1)

    def _begin_store(self, item: WorkItem, c: int, r: int) -> PhaseCost:
        eng = self.engine
        res_out = self._result
        stats: RoundStats = item.data["stats"]
        out_rows: Dict[str, np.ndarray] = {}
        logit_rows: Dict[str, np.ndarray] = {}
        for part in item.data["parts"]:
            outputs, cache, dt_dec = eng._decode_finish(part["decode"])
            stats.t_decode += dt_dec
            for i, a in enumerate(part["aids"]):
                eng.sessions[a].state.extend_history(outputs[i])
                eng.last_outputs[a] = outputs[i]
                out_rows[a] = outputs[i]
            eng.policy.store(part["ctx"], cache, outputs, part["res"],
                             stats)
            logits_np = (part["res"].logits.float().cpu().numpy()
                         if eng.keep_logits else None)
            for i, a in enumerate(part["aids"]):
                logit_rows[a] = (logits_np[i] if logits_np is not None
                                 else None)
        admitted = item.data["admitted"]
        if admitted:
            stats.outputs = np.stack([out_rows[a] for a in admitted])
            if eng.keep_logits:
                stats.first_logits = np.stack(
                    [logit_rows[a] for a in admitted])
        stats.transient_peak_bytes = eng.pool.peak_bytes()
        self._free_committee_transients(c, admitted)
        if item.data["prefetch_pending"]:
            eng.manager.prefetch(item.data["prefetch_pending"])
            item.data["prefetch_pending"] = []
        dev, host, cache_b = eng._persistent_split()
        stats.persistent_bytes = dev + host
        pool_delta = eng.manager.ledger.scoped_delta(
            item.data["scoped_before"]).get(f"g{c}", {})
        pool_delta["persistent_device_bytes"] = dev
        pool_delta["persistent_host_bytes"] = host
        pool_delta["restore_cache_bytes"] = cache_b
        stats.merge_reuse("pool", pool_delta)
        res_out.stats[c].append(stats)
        for part in item.data["parts"]:
            for a in part["aids"]:
                res_out.outputs[a].append(out_rows[a])
                res_out.logits[a].append(logit_rows[a])
                res_out.token_ticks[a].append(part["ticks"][a])
        if self._planner is not None:
            self._planner.observe(
                stats, collective=getattr(
                    eng.policy, "collective",
                    eng.policy.name == "tokendance"))
        item.data.pop("parts", None)   # drop caches/decode states
        return PhaseCost(0)

    # ------------------------------------------------------------ helpers
    def _note_overlap(self, c: int) -> None:
        """Count a restore/prefill phase_begin that runs while another
        committee's decode is mid-flight (the spy-test witness)."""
        for (oc, _), it in self.scheduler.items.items():
            if oc == c or it.phase != Phase.DECODE or not it.started:
                continue
            if 0 < it.units_left:
                self._restore_overlap += 1
                return

    def _committee_round(self, r: int) -> Round:
        """Generate-mode round reconstruction, exactly the synchronized
        engine's: each agent's block is its OWN last output (committees
        are independent, so a member's block list position for any other
        committee's agent is never read by this committee's prompts)."""
        eng = self.engine
        rnd = self._rounds[r]
        if r == 0 or not eng.last_outputs:
            return rnd
        fallback = eng._replay_fallback_blocks(rnd)
        shared = []
        for a in eng.sessions:
            prev = eng.last_outputs.get(a, fallback.get(a))
            assert prev is not None, f"no output block for agent {a}"
            shared.append(prev)
        return Round(rnd.index, shared, rnd.tasks)

    def _free_committee_transients(self, c: int,
                                   admitted: List[str]) -> None:
        eng = self.engine
        for a in admitted:
            eng.manager.free(f"round:{a}")
        # the within-round restore pool: "restore:family:g<c>" plus the
        # partition/family-suffixed variants "restore:family:g<c>.…"
        # (the dotted prefix avoids matching g<c'> for c' = c*10 + d)
        eng.manager.free(f"restore:family:g{c}")
        eng.manager.free_transient(prefixes=[f"restore:family:g{c}."])

    def _issue_prefetch(self, item: WorkItem, c: int, r: int) -> List[str]:
        """Owners this committee's round r+1 restore will read, reloaded
        while its decode runs. Returns owners that did not fit yet; the
        STORE phase retries them after the round's transients are
        freed."""
        eng = self.engine
        if r + 1 >= len(self._rounds):
            return []
        members = self._committees[c]
        if self._planner is not None:
            nxt = self._planner.plan_round(r + 1, list(members))
            self._next_plans[(c, r + 1)] = nxt
            next_admitted = nxt.admitted
        else:
            next_admitted = members
        owners = eng.manager.prefetch_planner.owners_for(
            eng.sessions, next_admitted, exclude=item.data["admitted"])
        if not owners:
            return []
        return eng.manager.prefetch(owners)

    def _stream_tokens(self, part: dict, st: DecodeState, r: int,
                       tick: int) -> None:
        for a in part["aids"]:
            part["ticks"][a].append(tick)
        if self._on_token is not None:
            toks = st.tok.cpu().numpy()
            for i, a in enumerate(part["aids"]):
                self._on_token(a, r, st.t, int(toks[i]), tick)
