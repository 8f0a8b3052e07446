"""The SLO planner and capacity model in the port
(``serving/scheduler.py``, ``serving/planner.py::RoundPlanner``), case by
case against the JAX package: the pure functions on a grid of inputs
(exact, ``inf`` past saturation included), the round-robin admission,
the measurement refit, and the engine served under admission (smoke
qwen2.5-7b in f32, ``generative_agents`` 4 agents, seed 11, gen 32)."""
import itertools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params as jax_init
from repro.serving import RoundPlan as JaxPlan
from repro.serving import RoundPlanner as JaxPlanner
from repro.serving import ServiceTimes as JaxTimes
from repro.serving import ServingEngine as JaxEngine
from repro.serving import scheduler as jax_sched
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import from_jax
from repro_torch.serving import (RoundPlan, RoundPlanner, ServiceTimes,
                                 ServingEngine, max_agents_under_slo,
                                 service_times_from_stats,
                                 simulate_round_latency)
from repro_torch.serving import scheduler as torch_sched

torch.set_num_threads(1)

N_AGENTS, GEN = 4, 32
KW = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)


def _times(cls, collective, persistent, recompute):
    return cls(per_request_recover=0.1, collective_recover=0.15,
               decode=0.05, restore=0.01, store=0.002,
               collective=collective, persistent_per_agent=persistent,
               recompute_round=recompute)


POINTS = list(itertools.product((False, True), (0.0, 1000.0),
                                (0.0, 0.9)))


def _serial(cls):
    """The JAX tests' a-priori model: 0.1 s a serial request + 0.05 s
    decode; at qps 2 and an SLO of 0.35 s two agents fit."""
    return lambda n: cls(per_request_recover=0.1, collective_recover=0.15,
                         decode=0.05, collective=False)


class _Stats:
    """A minimal RoundStats stand-in."""

    def __init__(self, n_agents, t_recover, t_decode, t_restore, t_store,
                 persistent_bytes):
        self.n_agents = n_agents
        self.t_recover, self.t_decode = t_recover, t_decode
        self.t_restore, self.t_store = t_restore, t_store
        self.persistent_bytes = persistent_bytes


# ------------------------------------------------------------ pure model
@pytest.mark.parametrize("point", POINTS)
def test_latency_grid_equals_jax(point):
    """``round_service_time`` and ``simulate_round_latency`` equal to the
    last bit over agent counts, loads (0 to past saturation, where both
    give ``inf``) and pool budgets (none, binding, ample)."""
    tst, jst = _times(ServiceTimes, *point), _times(JaxTimes, *point)
    n_inf = 0
    for n, qps, budget in itertools.product(range(1, 9),
                                            (0.0, 0.5, 2.0, 8.0, 30.0),
                                            (0.0, 2500.0, 1e9)):
        got = simulate_round_latency(tst, n, qps, pool_budget_bytes=budget)
        want = jax_sched.simulate_round_latency(jst, n, qps,
                                                pool_budget_bytes=budget)
        assert got == want, (point, n, qps, budget, got, want)
        assert torch_sched.round_service_time(tst, n, budget) == \
            jax_sched.round_service_time(jst, n, budget)
        n_inf += math.isinf(got)
    assert n_inf > 0


@pytest.mark.parametrize("point", POINTS)
def test_max_agents_under_slo_grid_equals_jax(point):
    tst, jst = _times(ServiceTimes, *point), _times(JaxTimes, *point)
    caps = set()
    for qps, slo, budget, rng in itertools.product(
            (0.5, 2.0, 8.0), (0.2, 0.35, 1.0, 10.0), (0.0, 2500.0),
            (range(1, 9), range(1, 5), [2, 4, 8])):
        got = max_agents_under_slo(lambda n: tst, qps, slo, rng, budget)
        want = jax_sched.max_agents_under_slo(lambda n: jst, qps, slo, rng,
                                              budget)
        assert got == want, (point, qps, slo, budget, rng)
        caps.add(got)
    assert len(caps) > 2


def test_max_agents_under_slo_caps_admission():
    """The JAX test's cases, in the port."""
    m = _serial(ServiceTimes)
    assert max_agents_under_slo(m, 2.0, 0.35, range(1, 9)) == 2
    assert max_agents_under_slo(m, 2.0, 10.0, range(1, 5)) == 4
    coll = lambda n: ServiceTimes(per_request_recover=0.1,  # noqa: E731
                                  collective_recover=0.15, decode=0.05,
                                  collective=True)
    assert (max_agents_under_slo(coll, 2.0, 0.35, range(1, 9))
            > max_agents_under_slo(m, 2.0, 0.35, range(1, 9)))


def test_service_times_from_stats_equals_jax():
    for n, coll, rec in itertools.product((1, 3, 4), (False, True),
                                          (0.0, 0.9)):
        s = _Stats(n, 0.4, 0.1, 0.02, 0.01, 4000)
        got = service_times_from_stats(s, n, collective=coll,
                                       recompute_round=rec)
        want = jax_sched.service_times_from_stats(s, n, collective=coll,
                                                  recompute_round=rec)
        assert vars(got) == vars(want)
    st = service_times_from_stats(_Stats(4, 0.4, 0.1, 0.02, 0.01, 4000), 4,
                                  collective=False, recompute_round=0.9)
    assert st.per_request_recover == pytest.approx(0.1)
    assert st.persistent_per_agent == pytest.approx(1000)
    assert np.isfinite(simulate_round_latency(st, 4, qps=1.0))


# --------------------------------------------------------------- planner
@pytest.mark.parametrize("n_ids", [1, 3, 6, 7])
def test_plan_round_sequences_equal_jax(n_ids):
    """Eight planned rounds: the same admitted / deferred lists, caps and
    round-robin cursor; no model (or no load) admits everyone."""
    aids = [f"a{i}" for i in range(n_ids)]
    tp = RoundPlanner(measure=_serial(ServiceTimes), qps=2.0, slo_s=0.35)
    jp = JaxPlanner(measure=_serial(JaxTimes), qps=2.0, slo_s=0.35)
    for r in range(8):
        got, want = tp.plan_round(r, aids), jp.plan_round(r, aids)
        assert (got.round_idx, got.admitted, got.deferred, got.max_agents,
                got.topology) == (want.round_idx, want.admitted,
                                  want.deferred, want.max_agents,
                                  want.topology), r
    assert tp.admission_active and jp.admission_active
    for kw in ({}, {"measure": _serial(ServiceTimes)},
               {"measure": _serial(ServiceTimes), "qps": 2.0}):
        pl = RoundPlanner(**kw)
        assert not pl.admission_active
        assert pl.plan_round(0, aids).admitted == aids


def test_planner_emits_round_robin_plans():
    aids = [f"a{i}" for i in range(6)]
    pl = RoundPlanner(measure=_serial(ServiceTimes), qps=2.0, slo_s=0.35)
    plan = pl.plan_round(0, aids)
    assert isinstance(plan, RoundPlan)
    assert (plan.admitted, plan.deferred, plan.max_agents) == \
        (aids[:2], aids[2:], 2)
    assert pl.plan_round(1, aids).admitted == aids[2:4]
    assert pl.plan_round(2, aids).admitted == aids[4:6]
    assert pl.plan_round(3, aids).admitted == aids[:2]


@pytest.mark.parametrize("refit_every", [0, 1, 2, 3])
def test_observe_refits_equal_jax(refit_every):
    """The same observations (an empty round among them) give the same
    refit count, fitted model and caps in both packages."""
    aids = [f"a{i}" for i in range(6)]
    tp = RoundPlanner(measure=_serial(ServiceTimes), qps=2.0, slo_s=0.35,
                      refit_every=refit_every)
    jp = JaxPlanner(measure=_serial(JaxTimes), qps=2.0, slo_s=0.35,
                    refit_every=refit_every)
    obs = [_Stats(4, 0.02, 0.01, 0.0, 0.0, 4000),
           _Stats(0, 0.0, 0.0, 0.0, 0.0, 0),
           _Stats(2, 0.5, 0.2, 0.01, 0.003, 3000),
           _Stats(4, 0.03, 0.02, 0.001, 0.0, 4100),
           _Stats(3, 0.01, 0.01, 0.0, 0.001, 2000)]
    for i, s in enumerate(obs):
        tp.observe(s, collective=i % 2 == 0, recompute_round=0.5)
        jp.observe(s, collective=i % 2 == 0, recompute_round=0.5)
        assert tp.refits == jp.refits, i
        assert vars(tp.measure(4)) == vars(jp.measure(4)), i
        assert tp.plan_round(i, aids).admitted == \
            jp.plan_round(i, aids).admitted, i
    assert tp.refits == (0 if refit_every == 0 else 4 // refit_every)
    if refit_every == 0:
        assert tp.measure(4) == _serial(ServiceTimes)(4)


# ---------------------------------------------------------- engine level
@pytest.fixture(scope="module")
def weights():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return np.asarray(x).tolist()


def _assert_rounds_equal(ts, js):
    assert len(ts) == len(js)
    for r, (t, j) in enumerate(zip(ts, js)):
        assert t.n_agents == j.n_agents and t.prompt_len == j.prompt_len, r
        np.testing.assert_array_equal(t.outputs, j.outputs, err_msg=str(r))
        np.testing.assert_allclose(t.first_logits, j.first_logits,
                                   atol=2e-4, rtol=0, err_msg=str(r))
        assert t.admission == j.admission, r
        want = {k: v for k, v in j.reuse.items() if k != "plan"}
        assert _plain(t.reuse) == _plain(want), r
        assert t.persistent_bytes == j.persistent_bytes, r
        assert t.transient_peak_bytes == j.transient_peak_bytes, r


def _trace(gen, cfg, n_rounds):
    return gen("generative_agents", N_AGENTS, n_rounds, cfg.vocab_size,
               seed=11, jitter_hist=False)


def test_serve_applies_admission_as_jax(weights):
    """A binding SLO defers half the agents each round, round-robin: the
    same admissions, tokens and ledgers as the JAX engine, and the same
    histories (a deferred agent's pauses)."""
    cfg, params, tcfg, tparams = weights
    jeng = JaxEngine(params, cfg, **KW)
    js = jeng.serve(_trace(generate_trace, cfg, 3),
                    JaxPlanner(measure=_serial(JaxTimes), qps=2.0,
                               slo_s=0.35))
    teng = ServingEngine(tparams, tcfg, **KW)
    ts = teng.serve(_trace(torch_trace, tcfg, 3),
                    RoundPlanner(measure=_serial(ServiceTimes), qps=2.0,
                                 slo_s=0.35))
    _assert_rounds_equal(ts, js)
    assert [s.admission["admitted"] for s in ts] == [
        ["agent0", "agent1"], ["agent2", "agent3"], ["agent0", "agent1"]]
    for s in ts:
        assert s.n_agents == 2 and s.admission["max_agents"] == 2
    for a in teng.sessions:
        assert teng.sessions[a].state.history.shape == \
            jeng.sessions[a].state.history.shape
    assert teng.sessions["agent0"].state.history.shape[0] == 64 + 2 * GEN
    assert teng.sessions["agent3"].state.history.shape[0] == 64 + GEN


def test_readmitted_agents_rejoin_as_jax(weights):
    """Two agents deferred in round 0 rejoin in round 1 with shorter
    histories (two equal-length batches in the group), then everyone is
    served again: tokens, ledgers and the Master families equal JAX's."""
    cfg, params, tcfg, tparams = weights
    out = {}
    for name, make, gen, plan in (
            ("jax", lambda: JaxEngine(params, cfg, **KW), generate_trace,
             JaxPlan),
            ("torch", lambda: ServingEngine(tparams, tcfg, **KW),
             torch_trace, RoundPlan)):
        eng = make()
        trace = _trace(gen, cfg, 3)
        eng.init_agents(trace)
        aids = list(eng.sessions)
        stats = [eng.run_round(trace.rounds[0],
                               plan(0, aids[:2], aids[2:], max_agents=2))]
        for r in (1, 2):
            stats.append(eng.run_round(trace.rounds[r],
                                       plan(r, aids, [], max_agents=4)))
        out[name] = (eng, stats)
    (jeng, js), (teng, ts) = out["jax"], out["torch"]
    _assert_rounds_equal(ts, js)
    assert ts[1].outputs.shape == (N_AGENTS, GEN)
    assert isinstance(ts[1].reuse["n_sel"], list)    # one entry a batch
    assert set(teng.policy.masters) == set(jeng.policy.masters) == \
        {teng.sessions[a].family for a in teng.sessions}


def test_serve_feeds_observations_as_jax(weights):
    """serve() closes the measurement loop in both packages: with
    ``refit_every=1`` every served round refits the model (the fitted
    times are each engine's own measurements), admissions are equal
    while the a-priori model still decides, and each refit's fitted
    point is collective with the engine's own round-1 times."""
    cfg, params, tcfg, tparams = weights
    jp = JaxPlanner(measure=_serial(JaxTimes), qps=2.0, slo_s=0.35,
                    refit_every=1)
    js = JaxEngine(params, cfg, **KW).serve(_trace(generate_trace, cfg, 2),
                                            jp)
    tp = RoundPlanner(measure=_serial(ServiceTimes), qps=2.0, slo_s=0.35,
                      refit_every=1)
    ts = ServingEngine(tparams, tcfg, **KW).serve(
        _trace(torch_trace, tcfg, 2), tp)
    assert tp.refits == jp.refits == 2
    # rounds 0 and 1 were planned before the first observation
    assert [s.admission for s in ts] == [s.admission for s in js]
    st = tp.measure(2)
    assert st.collective and st.collective_recover == ts[1].t_recover
    assert st.persistent_per_agent == ts[1].persistent_bytes / 2


def test_serve_without_planner_is_unchanged(weights):
    _, _, tcfg, tparams = weights
    a = ServingEngine(tparams, tcfg, **KW).serve(_trace(torch_trace, tcfg, 2))
    b = ServingEngine(tparams, tcfg, **KW).serve(
        _trace(torch_trace, tcfg, 2), RoundPlanner())
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sa.outputs, sb.outputs)
        np.testing.assert_array_equal(sa.first_logits, sb.first_logits)
        assert sa.admission is None
        assert sb.admission == {"max_agents": 0, "deferred": [],
                                "admitted": [f"agent{i}"
                                             for i in range(N_AGENTS)]}
