"""The continuous serving loop in the port (``serving/loop``): the step
scheduler against the JAX package's on the same scripted costs, and the
continuous engine against the port's synchronized ``serve()`` (its
bit-exact oracle) and against the JAX ``ContinuousEngine`` on the
artifact's configuration (smoke qwen2.5-7b in f32, ``generative_agents``,
seed 11, gen 32, recompute_ratio 0.1)."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import SubsetGather as JaxSubsetGather
from repro.core.rounds import generate_trace
from repro.models import init_params as jax_init
from repro.serving import ContinuousEngine as JaxContinuous
from repro.serving import Phase as JaxPhase
from repro.serving import PhaseCost as JaxCost
from repro.serving import StepScheduler as JaxScheduler
from repro.serving import WorkItem as JaxItem
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import SubsetGather
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import from_jax
from repro_torch.serving import (ContinuousEngine, ContinuousResult, Phase,
                                 PhaseCost, RoundPlanner, ServiceTimes,
                                 ServingEngine, StepScheduler, WorkItem)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GEN = 32


# ------------------------------------------------------ scheduler (unit)
class ScriptedExecutor:
    """Phase costs from a table; records every hook call in order."""

    def __init__(self, costs):
        self.costs = costs            # {(c, r, phase): (units, slots, per)}
        self.cost_cls = None
        self.begins, self.runs, self.ends = [], [], []

    def phase_begin(self, item):
        self.begins.append((item.committee, item.round_idx, item.phase))
        return self.cost_cls(*self.costs.get(
            (item.committee, item.round_idx, item.phase), (0,)))

    def run_units(self, item, k, tick):
        self.runs.append((tick, item.committee, item.round_idx, item.phase,
                          k))

    def phase_end(self, item, tick):
        self.ends.append((tick, item.committee, item.round_idx, item.phase))


def _costs(n_c, n_r, *, restore=0, prefill=8, decode=7, agents=2):
    costs = {}
    for c in range(n_c):
        for r in range(n_r):
            costs[(c, r, Phase.RESTORE)] = (restore,)
            costs[(c, r, Phase.PREFILL)] = (prefill,)
            costs[(c, r, Phase.DECODE)] = (decode, agents, 1)
    return costs


# (name, committees, rounds, costs, slots, arrivals): the schedules of the
# JAX package's scheduler tests
SCHEDULES = [
    ("lifecycle", 2, 2, _costs(2, 2), 8, None),
    ("sequential_rounds", 2, 3, _costs(2, 3), 8, None),
    ("decode_one_step_a_tick", 1, 1, _costs(1, 1, prefill=8, decode=7), 8,
     None),
    ("decode_lane_budget", 2, 1, _costs(2, 1, prefill=3, decode=5), 3, None),
    ("stagger", 2, 2, _costs(2, 2, prefill=16, decode=10), 8, [0, 3]),
    ("three_committees", 3, 2,
     _costs(3, 2, restore=4, prefill=12, decode=9), 7, [0, 2, 5]),
]


def _run(sched_cls, cost_cls, n_c, n_r, costs, slots, arrivals):
    ex = ScriptedExecutor(costs)
    ex.cost_cls = cost_cls
    sched = sched_cls(ex, n_c, n_r, slots_per_step=slots, arrivals=arrivals)
    makespan = sched.run()
    events = [(e.tick, e.committee, e.round_idx, e.phase, e.units)
              for e in sched.timeline]
    return ex, sched, (makespan, sched.sync_makespan(),
                       sched.overlap_steps(), events, ex.begins, ex.runs,
                       ex.ends)


@pytest.mark.parametrize("case", SCHEDULES, ids=[c[0] for c in SCHEDULES])
def test_schedule_equals_jax(case):
    """Makespan, synchronized baseline, overlap steps, the timeline and
    every executor call, equal to JAX's scheduler on the same costs."""
    _, n_c, n_r, costs, slots, arrivals = case
    _, _, got = _run(StepScheduler, PhaseCost, n_c, n_r, costs, slots,
                     arrivals)
    _, _, want = _run(JaxScheduler, JaxCost, n_c, n_r, costs, slots,
                      arrivals)
    assert got == want
    _, _, again = _run(StepScheduler, PhaseCost, n_c, n_r, costs, slots,
                       arrivals)
    assert again == got                        # deterministic


def test_schedule_properties():
    """The JAX tests' assertions on the port's scheduler: lifecycle order,
    sequential rounds, one decode step a tick, the decode lane's budget,
    and a stagger that overlaps and beats the synchronized baseline."""
    ex, _, _ = _run(StepScheduler, PhaseCost, 2, 3, _costs(2, 3), 8, None)
    for c in range(2):
        for r in range(3):
            seq = [p for (bc, br, p) in ex.begins if (bc, br) == (c, r)]
            assert seq == list(Phase.ORDER)
        for r in range(2):
            assert ex.begins.index((c, r + 1, Phase.PLAN)) > \
                ex.begins.index((c, r, Phase.STORE))
    ex, sched, (makespan, sync, *_) = _run(
        StepScheduler, PhaseCost, 1, 1, _costs(1, 1, prefill=8, decode=7),
        8, None)
    dec = [e for e in ex.runs if e[3] == Phase.DECODE]
    assert [e[4] for e in dec] == [1] * 7
    assert makespan == 8 == sync
    ex, _, _ = _run(StepScheduler, PhaseCost, 2, 1,
                    _costs(2, 1, prefill=3, decode=5), 3, None)
    t0 = [e[0] for e in ex.runs if e[3] == Phase.DECODE and e[1] == 0]
    t1 = [e[0] for e in ex.runs if e[3] == Phase.DECODE and e[1] == 1]
    assert len(t0) == len(t1) == 5 and min(t1) > max(t0)
    _, sched, (makespan, sync, overlap, *_) = _run(
        StepScheduler, PhaseCost, 2, 2, _costs(2, 2, prefill=16, decode=10),
        8, [0, 3])
    assert overlap > 0 and makespan < sync


def test_oversized_phase_unit_is_rejected():
    for sched_cls, cost_cls in ((StepScheduler, PhaseCost),
                                (JaxScheduler, JaxCost)):
        ex = ScriptedExecutor({(0, 0, Phase.DECODE): (4, 9, 1)})
        ex.cost_cls = cost_cls
        with pytest.raises(AssertionError, match="slots per"):
            sched_cls(ex, 1, 1, slots_per_step=8).run()


def test_work_item_walks_the_phases_as_jax():
    assert Phase.ORDER == JaxPhase.ORDER
    assert Phase.DONE == JaxPhase.DONE
    got, want = WorkItem(1, 2, ready_at=3), JaxItem(1, 2, ready_at=3)
    keys = []
    while not got.done:
        assert got.key == want.key and not want.done
        keys.append(got.key)
        got.units_left = want.units_left = 5
        got.advance_phase()
        want.advance_phase()
        assert vars(got) == vars(want)
    assert want.done and len(keys) == len(Phase.ORDER)
    assert keys[0] == (1, 2, Phase.PLAN)


# -------------------------------------------------------- engine (model)
@pytest.fixture(scope="module")
def weights():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


KW = dict(gen_len=GEN, recompute_ratio=0.1)


def _trace(gen, vocab, n_agents, n_rounds):
    return gen("generative_agents", n_agents, n_rounds, vocab, seed=11,
               jitter_hist=False)


def _oracle_rows(stats, aids):
    """Per-agent output / logit rows of a synchronized serve (rows are
    stacked in admitted order)."""
    out = {a: [] for a in aids}
    lg = {a: [] for a in aids}
    for st in stats:
        admitted = st.admission["admitted"] if st.admission else list(aids)
        for i, a in enumerate(admitted):
            out[a].append(st.outputs[i])
            lg[a].append(None if st.first_logits is None
                         else st.first_logits[i])
    return out, lg


def _assert_parity(res, stats, aids):
    out, lg = _oracle_rows(stats, aids)
    for a in aids:
        assert len(res.outputs[a]) == len(out[a])
        for got, want in zip(res.outputs[a], out[a]):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(res.logits[a], lg[a]):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def single(weights):
    """One committee (All-Gather), 4 agents, 3 rounds: the port's
    synchronized serve and its continuous serve with a token stream."""
    _, _, tcfg, tparams = weights
    oracle = ServingEngine(tparams, tcfg, keep_logits=True, **KW).serve(
        _trace(torch_trace, tcfg.vocab_size, 4, 3))
    cont = ContinuousEngine(tparams, tcfg, "tokendance", keep_logits=True,
                            **KW)
    stream = []
    res = cont.serve(_trace(torch_trace, tcfg.vocab_size, 4, 3),
                     on_token=lambda *ev: stream.append(ev))
    return oracle, cont, res, stream


def test_single_committee_is_bit_exact_oracle(single):
    """Outputs AND first-token logits bit-equal to the synchronized
    serve, its makespan equal to the synchronized baseline, nothing to
    overlap with, and the same ledgers."""
    oracle, cont, res, _ = single
    assert isinstance(res, ContinuousResult)
    aids = [f"agent{i}" for i in range(4)]
    _assert_parity(res, oracle, aids)
    assert res.makespan_steps == res.sync_makespan_steps
    assert res.overlap_steps == 0 and res.restore_overlap_events == 0
    assert len(res.stats[0]) == 3
    for got, want in zip(res.stats[0], oracle):
        assert got.persistent_bytes == want.persistent_bytes
        for key in ("restore", "n_sel", "compression", "align_passes"):
            assert got.reuse.get(key) == want.reuse.get(key), key
    cont.engine.manager.check()


def test_tokens_stream_per_tick(single):
    """Each round's G tokens carry nondecreasing ticks inside the
    makespan, rounds do not interleave, and the stream saw exactly the
    stored outputs (slot 0, the prefill's token, is not streamed)."""
    _, _, res, stream = single
    for a, rounds in res.token_ticks.items():
        prev = -1
        for ticks in rounds:
            assert len(ticks) == GEN and ticks == sorted(ticks)
            assert ticks[0] > prev and ticks[-1] <= res.makespan_steps
            prev = ticks[-1]
    by_round = {}
    for a, r, t, tok, tick in stream:
        by_round.setdefault((a, r), []).append((t, tok, tick))
    for a in res.token_ticks:
        for r in range(3):
            ev = by_round[(a, r)]
            assert [t for t, _, _ in ev] == list(range(1, GEN))
            np.testing.assert_array_equal([tok for _, tok, _ in ev],
                                          res.outputs[a][r][1:])
            assert [tick for *_, tick in ev] == res.token_ticks[a][r][1:]


def test_planner_admission_matches_synchronized(weights):
    """RoundPlanner admission plugs into the continuous loop with the
    synchronized engine's semantics: same rotation, same outputs."""
    _, _, tcfg, tparams = weights

    def planner():
        return RoundPlanner(measure=lambda n: ServiceTimes(
            per_request_recover=0.1, collective_recover=0.15, decode=0.05,
            collective=False), qps=2.0, slo_s=0.35)

    oracle = ServingEngine(tparams, tcfg, keep_logits=True, **KW).serve(
        _trace(torch_trace, tcfg.vocab_size, 4, 3), planner())
    res = ContinuousEngine(tparams, tcfg, keep_logits=True, **KW).serve(
        _trace(torch_trace, tcfg.vocab_size, 4, 3), planner())
    for o, c in zip(oracle, res.stats[0]):
        assert o.admission == c.admission
    _assert_parity(res, oracle, [f"agent{i}" for i in range(4)])


# ------------------------------------- the artifact's configuration
N_MULTI, STAGGER = 6, [0, 8, 16]
AIDS = [f"agent{i}" for i in range(N_MULTI)]


@pytest.fixture(scope="module")
def multi(weights):
    """Three committees of two, staggered arrivals, 3 rounds
    (``benchmarks/capacity.py::continuous_serving``): the JAX continuous
    engine, the port's, and the port's synchronized serve on the same
    grouped topology. A spy on the port's ``policy.plan`` records which
    OTHER committees hold an undrained decode when a restore plans."""
    cfg, params, tcfg, tparams = weights
    jres = JaxContinuous(
        params, cfg, "tokendance",
        topology=JaxSubsetGather.grouped(AIDS, 2), **KW).serve(
        _trace(generate_trace, cfg.vocab_size, N_MULTI, 3), stagger=STAGGER)
    topo = SubsetGather.grouped(AIDS, 2)
    oracle = ServingEngine(tparams, tcfg, topology=topo, keep_logits=True,
                           **KW).serve(
        _trace(torch_trace, tcfg.vocab_size, N_MULTI, 3))
    cont = ContinuousEngine(tparams, tcfg, "tokendance", topology=topo,
                            keep_logits=True, **KW)
    plan_log = []
    plan = cont.engine.policy.plan

    def spy(ctx):
        decoding = {it.committee for it in cont.scheduler.items.values()
                    if it.phase == Phase.DECODE and it.started
                    and it.units_left > 0}
        plan_log.append((int(ctx.gid[1:].split(".")[0]), decoding))
        return plan(ctx)

    cont.engine.policy.plan = spy
    res = cont.serve(_trace(torch_trace, tcfg.vocab_size, N_MULTI, 3),
                     stagger=STAGGER)
    del cont.engine.policy.plan
    return jres, oracle, cont, res, plan_log


def _counted(r):
    return (r.makespan_steps, r.sync_makespan_steps, r.overlap_steps,
            r.restore_overlap_events, len(r.timeline))


def test_counted_fields_equal_jax_and_artifact(multi):
    """Makespan, synchronized makespan, overlap steps, restore-overlap
    events and timeline events equal the JAX engine's on the same run,
    event for event, and ``experiments/bench/continuous_serving.json``
    (which the current JAX engine still reproduces)."""
    jres, _, _, res, _ = multi
    assert _counted(res) == _counted(jres)
    assert [(e.tick, e.committee, e.round_idx, e.phase, e.units)
            for e in res.timeline] == \
        [(e.tick, e.committee, e.round_idx, e.phase, e.units)
         for e in jres.timeline]
    art = json.loads((ROOT / "experiments/bench/continuous_serving.json")
                     .read_text())
    assert art["config"]["stagger_steps"] == STAGGER
    assert art["config"]["slots_per_step"] == 2 * N_MULTI
    assert _counted(res) == (art["makespan"]["continuous_steps"],
                             art["makespan"]["synchronized_steps"],
                             art["overlap_steps"],
                             art["restore_overlap_events"],
                             art["timeline_events"]) == \
        (377, 588, 227, 10, 635)
    for a in AIDS:
        for got, want in zip(res.outputs[a], jres.outputs[a]):
            np.testing.assert_array_equal(got, want)


def test_multi_committee_parity_bit_exact(multi):
    """Per agent, outputs and first-token logits bit-equal to the port's
    synchronized serve on the same topology; the pool, its scopes and
    every family's history pool stay consistent."""
    _, oracle, cont, res, _ = multi
    _assert_parity(res, oracle, AIDS)
    assert all(len(res.stats[c]) == 3 for c in res.stats)
    cont.engine.manager.check()
    cont.engine.manager.ledger.check_scopes()
    assert set(cont.engine.manager.ledger.scoped_snapshot()) <= \
        {"engine", "g0", "g1", "g2"}
    for pool in cont.engine.policy.hist_pools.values():
        pool.check()


def test_restore_runs_during_other_committees_decode(multi):
    """The round barrier is broken: a committee's restore planned while
    another committee's decode held undrained steps (spy-pinned), and the
    makespan is below the synchronized one."""
    _, _, _, res, plan_log = multi
    assert [(c, d) for c, d in plan_log if d - {c}]
    assert res.restore_overlap_events > 0
    assert res.makespan_steps < res.sync_makespan_steps
