"""The cross-round incremental restore in the port against the JAX package,
engine by engine (its unit mechanics: ``test_torch_histpool.py``).

Held here, at the smoke ``qwen2.5-7b`` config in f32 with the JAX weights
carried over (``from_jax``):

* inside the port, incremental == full restore == dense-history oracle,
  outputs and first logits bit for bit, every round, and every pool's
  invariants after every round;
* against the JAX engine with the same defaults on the same trace and
  plans: greedy tokens equal, first logits within 1e-4 (XLA and torch sum
  the same f32 products in another order), restore ledgers equal;
* that the pool's in-place writes cannot reach a reader: a round's
  entries die with the round.

The counterparts of ``tests/test_cross_round_restore.py`` and of
``tests/test_policy_parity.py::test_four_round_committee_parity``. Each
JAX engine runs once per module (``jax_served``).
"""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import SubsetGather as JaxSubsetGather
from repro.core.rounds import generate_trace as jax_trace
from repro.models import init_params as jax_init
from repro.serving import RoundPlan as JaxRoundPlan
from repro.serving import ServingEngine as JaxEngine
from repro.serving import TokenDancePolicy as JaxTokenDance
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.restore import gather_pages
from repro_torch.core.rounds import SubsetGather, generate_trace
from repro_torch.core.segments import PagedSegmentCacheEntry
from repro_torch.models import from_jax, init_params
from repro_torch.serving import RoundPlan, ServingEngine, TokenDancePolicy
from repro_torch.serving.pool import family_owners, hist_pool_owner

torch.set_num_threads(1)

GEN = 32
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


# ------------------------------------------------ engine-level core runner
def _policies():
    return {"inc": TokenDancePolicy(),
            "full": TokenDancePolicy(incremental=False),
            "dense": TokenDancePolicy(paged_history=False)}


def _plans(aids, r, admissions, regroup, jax_side):
    """The round's plan for one package (None: admit all, keep the
    engine's topology)."""
    Plan = JaxRoundPlan if jax_side else RoundPlan
    Subset = JaxSubsetGather if jax_side else SubsetGather
    plan = None
    if admissions is not None and admissions[r] is not None:
        adm = [aids[i] for i in admissions[r]]
        plan = Plan(r, adm, [a for a in aids if a not in adm],
                    max_agents=len(adm))
    if regroup is not None and r >= regroup[0]:
        plan = plan or Plan(r, list(aids), [], max_agents=len(aids))
        plan.topology = Subset.grouped(aids, regroup[1])
    return plan


def _case_key(n_agents, n_rounds, seed, topology=None, admissions=None,
              regroup=None):
    return (n_agents, n_rounds, seed, topology,
            None if admissions is None else tuple(
                None if a is None else tuple(a) for a in admissions),
            regroup)


@pytest.fixture(scope="module")
def jax_engine(setup):
    """JAX engines over the module's params that share one set of jit
    caches: their compiled steps close over the same params and config,
    so an engine reuses what an earlier one compiled."""
    cfg, params, _, _ = setup
    jit, collector_jit = {}, {}

    def make(policy, **kw):
        eng = JaxEngine(params, cfg, policy, **kw)
        eng.rt.jit = jit
        eng.collector._jit_cache = collector_jit
        return eng
    return make


@pytest.fixture(scope="module")
def jax_served(setup, jax_engine):
    """JAX default engine stats per case, each case served once."""
    cfg, _, _, _ = setup
    cache = {}

    def get(n_agents, n_rounds, seed, topology=None, admissions=None,
            regroup=None):
        key = _case_key(n_agents, n_rounds, seed, topology, admissions,
                        regroup)
        if key not in cache:
            trace = jax_trace("generative_agents", n_agents, n_rounds,
                              cfg.vocab_size, seed=seed, jitter_hist=False)
            aids = list(trace.agent_ids)
            topo = (JaxSubsetGather.grouped(aids, 2)
                    if topology == "grouped2" else None)
            eng = jax_engine(JaxTokenDance(), topology=topo, gen_len=GEN,
                             recompute_ratio=0.1, keep_logits=True)
            eng.init_agents(trace)
            cache[key] = [eng.run_round(rnd, _plans(aids, r, admissions,
                                                    regroup, True))
                          for r, rnd in enumerate(trace.rounds)]
        return cache[key]
    return get


def _infos(stats):
    ri = stats.reuse.get("restore")
    return ri if isinstance(ri, list) else [ri] if ri else []


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return np.asarray(x).tolist()


def _run_case(setup, *, n_agents, n_rounds, seed, topology=None,
              admissions=None, regroup=None, spill_after=()):
    """Serve one trace on the port's incremental / full / dense engines
    round by round; assert bit-exactness and every pool invariant per
    round. Returns the engines and their stats."""
    _, _, tcfg, tparams = setup
    trace = generate_trace("generative_agents", n_agents, n_rounds,
                           tcfg.vocab_size, seed=seed, jitter_hist=False)
    aids = list(trace.agent_ids)
    topo = SubsetGather.grouped(aids, 2) if topology == "grouped2" else None
    engines = {k: ServingEngine(tparams, tcfg, p, topology=topo, gen_len=GEN,
                                recompute_ratio=0.1, keep_logits=True)
               for k, p in _policies().items()}
    for eng in engines.values():
        eng.init_agents(trace)
    stats = {k: [] for k in engines}
    for r, rnd in enumerate(trace.rounds):
        plan = _plans(aids, r, admissions, regroup, False)
        for key, eng in engines.items():
            stats[key].append(eng.run_round(rnd, plan))
            eng.manager.check()
        for pool in engines["inc"].policy.hist_pools.values():
            pool.check()
        s_inc, s_full, s_dense = (stats[k][-1] for k in
                                  ("inc", "full", "dense"))
        for other in (s_full, s_dense):
            np.testing.assert_array_equal(s_inc.outputs, other.outputs)
            np.testing.assert_array_equal(s_inc.first_logits,
                                          other.first_logits)
        assert s_inc.persistent_bytes == s_full.persistent_bytes, r
        if r in spill_after:
            inc = engines["inc"]
            for pool in list(inc.policy.hist_pools.values()):
                assert inc.manager.spill(pool.owner)
    return engines, stats


def _assert_matches_jax(port_stats, jax_stats, *, pool_ledger=True):
    """Greedy tokens equal, first logits within LOGIT_ATOL, restore (and
    pool) ledgers equal, every round."""
    assert len(port_stats) == len(jax_stats)
    for r, (t, j) in enumerate(zip(port_stats, jax_stats)):
        np.testing.assert_array_equal(t.outputs, j.outputs)
        np.testing.assert_allclose(t.first_logits, j.first_logits,
                                   atol=LOGIT_ATOL, rtol=0)
        assert _plain(t.reuse.get("restore")) == \
            _plain(j.reuse.get("restore")), r
        if pool_ledger:
            assert _plain(t.reuse["pool"]) == _plain(j.reuse["pool"]), r
            assert t.persistent_bytes == j.persistent_bytes, r
        assert t.admission == j.admission, r


CASES = {
    "plain": dict(n_agents=3, n_rounds=4, seed=11),
    "pair": dict(n_agents=2, n_rounds=3, seed=7),
    "committees": dict(n_agents=3, n_rounds=3, seed=11,
                       topology="grouped2"),
    "defer_midtrace": dict(n_agents=3, n_rounds=4, seed=11,
                           admissions=[None, None, [0, 1], None]),
    "regroup_midtrace": dict(n_agents=3, n_rounds=4, seed=11,
                             regroup=(2, 2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cross_round_bitexact(setup, jax_served, name):
    """incremental == full == dense inside the port, outputs and logits,
    every round; tokens, logits and ledgers as the JAX engine's; and the
    incremental path really taken at some round."""
    case = CASES[name]
    _, stats = _run_case(setup, **case)
    _assert_matches_jax(stats["inc"], jax_served(**case))
    infos = [i for s in stats["inc"][1:] for i in _infos(s)]
    assert any(i["incremental"] for i in infos), infos


# ------------------------------------------------- eviction interaction
def test_spilled_pool_reloads_sync_and_bitexact(setup, jax_served):
    """Pages spilled between rounds reload through ensure_resident at the
    next restore (a sync reload in the round's pool ledger), and the
    restore stays incremental and bit-exact."""
    case = dict(n_agents=3, n_rounds=4, seed=11)
    engines, stats = _run_case(setup, spill_after=(1, 2), **case)
    inc = engines["inc"]
    for r in (2, 3):
        pool_delta = stats["inc"][r].reuse["pool"]
        assert pool_delta.get("sync_reloads", 0) + \
            pool_delta.get("prefetched_reloads", 0) >= 1, (r, pool_delta)
        assert stats["inc"][r].reuse["restore"]["incremental"] is True, r
    for pool in inc.policy.hist_pools.values():
        assert pool.owner in inc.pool._allocs
    # spills change the pool ledger only: tokens and restores as JAX's
    _assert_matches_jax(stats["inc"], jax_served(**case), pool_ledger=False)


def test_master_eviction_falls_back_to_full_restore(setup, jax_served):
    """Regrouping mid-trace evicts the old family's Master and its pool;
    each new family's next restore is a clean full restore, and no gather
    ever reads a pool dropped in an earlier round (spy-pinned by object
    identity; dropped tensors kept alive so ids cannot be recycled)."""
    case = dict(n_agents=3, n_rounds=4, seed=11, regroup=(2, 2))
    _, _, tcfg, tparams = setup
    trace = generate_trace("generative_agents", 3, 4, tcfg.vocab_size,
                           seed=11, jitter_hist=False)
    eng = ServingEngine(tparams, tcfg, TokenDancePolicy(), gen_len=GEN,
                        recompute_ratio=0.1, keep_logits=True)
    eng.init_agents(trace)
    aids = list(eng.sessions)
    dropped, gathered = [], []
    orig_drop = eng.policy._drop_hist_pool

    def spy_drop(fam):
        pool = eng.policy.hist_pools.get(fam)
        if pool is not None:
            dropped.append((eng.round_idx, pool.pool_k))
        orig_drop(fam)

    orig_reuse = eng.collector.collective_reuse

    def spy_reuse(ids, tokens, ck, cv, src, mask, n_sel, priv=None, **kw):
        if priv is not None and hasattr(priv, "pool_k"):
            gathered.append((eng.round_idx, priv.pool_k))
        return orig_reuse(ids, tokens, ck, cv, src, mask, n_sel, priv, **kw)

    eng.policy._drop_hist_pool = spy_drop
    eng.collector.collective_reuse = spy_reuse
    stats = []
    for r, rnd in enumerate(trace.rounds):
        stats.append(eng.run_round(rnd, _plans(aids, r, None, (2, 2), False)))
        for g_round, arr in gathered:
            assert not any(arr is d and d_round < g_round
                           for d_round, d in dropped), \
                f"round {g_round} gathered a dropped pool's pages"
    old_fam = tuple(aids)
    assert old_fam not in eng.policy.masters
    assert old_fam not in eng.policy.hist_pools
    assert hist_pool_owner(old_fam) not in eng.pool._allocs
    assert [i["incremental"] for i in _infos(stats[3])] == [False, False]
    assert set(eng.policy.hist_pools) == {("agent0", "agent1"), ("agent2",)}
    _assert_matches_jax(stats, jax_served(**case))


def test_deferred_member_invalidates_then_recovers(setup, jax_served):
    """A member deferred while its family's pool advances is not served
    stale pages: its next restore sees the span mismatch, drops the pool
    and full-restores; at round 4 the re-formed two-agent family is back
    on the incremental path while the deferred member's singleton family
    still bootstraps."""
    case = dict(n_agents=3, n_rounds=5, seed=11,
                admissions=[None, None, [0, 1], None, None])
    _, stats = _run_case(setup, **case)
    by_mirrors = {i["n_mirrors"]: i["incremental"]
                  for i in _infos(stats["inc"][-1])}
    assert by_mirrors.get(1) is True, by_mirrors
    assert by_mirrors.get(0) is False, by_mirrors
    _assert_matches_jax(stats["inc"], jax_served(**case))


def test_next_plan_prefetches_a_deferred_members_family(setup, jax_served):
    """``run_round(..., next_plan=)``: agent2 sits out round 2, and its
    family's Master, mirrors, cross-round pool and output segment are
    spilled once round 2's restore has read them. Round 2 names the
    owners round 3 will read (its next plan admits agent2 again) and
    reloads them beside its decode, so round 3's restore finds them warm:
    prefetch hits and no sync reload. Outputs and restores as the JAX
    engine's on the same schedule without spills."""
    case = CASES["defer_midtrace"]
    _, _, tcfg, tparams = setup
    trace = generate_trace("generative_agents", 3, 4, tcfg.vocab_size,
                           seed=11, jitter_hist=False)
    eng = ServingEngine(tparams, tcfg, TokenDancePolicy(), gen_len=GEN,
                        recompute_ratio=0.1, keep_logits=True)
    eng.init_agents(trace)
    aids = list(eng.sessions)
    recover = eng.policy.recover
    spilled = []

    def spill_then_recover(plan, tokens):
        if eng.round_idx == 2:
            fam = eng.sessions["agent2"].family
            for owner in (*family_owners(fam), hist_pool_owner(fam),
                          "out:agent2"):
                assert eng.manager.spill(owner), owner
                spilled.append(owner)
        return recover(plan, tokens)

    eng.policy.recover = spill_then_recover
    stats = []
    for r, rnd in enumerate(trace.rounds):
        plan = _plans(aids, r, case["admissions"], None, False)
        nxt = RoundPlan(3, list(aids)) if r == 2 else None
        stats.append(eng.run_round(rnd, plan, next_plan=nxt))
        eng.manager.check()
    assert len(spilled) == 4
    assert stats[2].reuse["pool"]["prefetched_reloads"] == 4
    assert stats[3].reuse["pool"]["prefetch_hits"] == 4
    assert stats[3].reuse["pool"].get("sync_reloads", 0) == 0
    _assert_matches_jax(stats, jax_served(**case), pool_ledger=False)


def test_forced_dirty_marks_are_correctness_neutral(setup):
    """Extra dirty marks (every member re-marks one prefix block) change
    page accounting, never values; cow_pages + cow_dedup_hits account for
    every mark, and members rewriting the Master's bytes share a page."""
    _, _, tcfg, tparams = setup
    trace = generate_trace("generative_agents", 3, 3, tcfg.vocab_size,
                           seed=11, jitter_hist=False)
    inc, full = (ServingEngine(tparams, tcfg, p, gen_len=GEN,
                               recompute_ratio=0.1, keep_logits=True)
                 for p in (TokenDancePolicy(),
                           TokenDancePolicy(incremental=False)))
    inc.init_agents(trace)
    full.init_agents(trace)
    for r in (0, 1):
        np.testing.assert_array_equal(inc.run_round(trace.rounds[r]).outputs,
                                      full.run_round(trace.rounds[r]).outputs)
    (fam, pool), = inc.policy.hist_pools.items()
    pend = pool.pending
    assert pend is not None
    already = {int(x) for a in fam
               for x in np.asarray(pend.dirty.get(a, []), np.int64).ravel()}
    b = next(x for x in range(pend.h_prev // pool.block_tokens)
             if x not in already)
    for a in fam:
        cur = np.asarray(pend.dirty.get(a, np.zeros(0, np.int32)))
        pend.dirty[a] = np.concatenate([cur, [b]]).astype(np.int32)
    total_marks = sum(int(np.asarray(pend.dirty[a]).size) for a in fam)
    si = inc.run_round(trace.rounds[2])
    sf = full.run_round(trace.rounds[2])
    np.testing.assert_array_equal(si.outputs, sf.outputs)
    np.testing.assert_array_equal(si.first_logits, sf.first_logits)
    ri = si.reuse["restore"]
    assert ri["incremental"] is True
    assert ri["cow_pages"] + ri["cow_dedup_hits"] == total_marks, ri
    sharers = [a for a in fam
               if inc.sessions[a].is_master
               or b not in set(map(int,
                                   inc.sessions[a].mirror.diff.block_idx))]
    if len(sharers) >= 2:
        assert len({int(pool.page_tables[a][b]) for a in sharers}) == 1
        assert ri["cow_dedup_hits"] >= len(sharers) - 1, ri
    pool.check()
    inc.manager.check()


def test_bf16_incremental_equals_full():
    """The served dtype: a bf16 model's round-0 family (and so its pool)
    is bf16, while recovery stores f32 families from round 1 on. The pool
    widens to f32 before the first delta lands, so the incremental restore
    stays bit-equal to the full restore, with the collector's paged path
    and with its densify oracle (casting the delta down to the pool's bf16
    would not).

    The dense-history oracle agrees in tokens and within 1e-4 in logits,
    not bit for bit, in bf16 as in the JAX package: the paged path rotates
    a bf16 tail (last round's output) to its new positions in bf16, the
    dense oracle rotates the same values held in f32
    (``core/pic.py::_paged_base_layer`` against the dense branch)."""
    cfg = torch_smoke("qwen2.5-7b").replace(dtype="bfloat16")
    params = init_params(cfg, 0, device="cpu")
    trace = generate_trace("generative_agents", 3, 4, cfg.vocab_size,
                           seed=11, jitter_hist=False)
    pols = dict(_policies(),
                inc_densify=TokenDancePolicy(paged_attention=False))
    stats = {k: ServingEngine(params, cfg, p, gen_len=GEN,
                              recompute_ratio=0.1,
                              keep_logits=True).serve(trace)
             for k, p in pols.items()}
    for r in range(4):
        for k in ("full", "inc_densify", "dense"):
            np.testing.assert_array_equal(stats["inc"][r].outputs,
                                          stats[k][r].outputs)
            np.testing.assert_allclose(
                stats["inc"][r].first_logits, stats[k][r].first_logits,
                atol=0 if k != "dense" else LOGIT_ATOL, rtol=0)
    assert [bool(_infos(s) and _infos(s)[0]["incremental"])
            for s in stats["inc"]] == [False, False, True, True]
    assert _infos(stats["inc"][3])[0]["cow_pages"] > 0


# ------------------------------------- in-place writes reach no reader
def test_entries_die_with_their_round_and_prefix_pages_keep_content(setup):
    """The pool writes in place, which is safe only if no reader outlives
    a write. Every entry a restore builds is unreachable once its round
    ends (weak references die), so no entry is alive when the next
    restore writes; and the prefix pages a round reuses read exactly what
    the previous round's entries read there, except the blocks that round
    recomputed."""
    _, _, tcfg, tparams = setup
    trace = generate_trace("generative_agents", 3, 4, tcfg.vocab_size,
                           seed=11, jitter_hist=False)
    eng = ServingEngine(tparams, tcfg, gen_len=GEN, recompute_ratio=0.1)
    eng.init_agents(trace)
    alive, seen = [], {}
    orig = eng.policy._restore_histories

    def spy(ctx):
        # no entry of an earlier round may be reachable while this
        # restore writes
        gc.collect()
        assert not [r for r, w in alive if w() is not None], alive
        out = orig(ctx)
        for a in ctx.agent_ids:
            e = eng.sessions[a].hist_entry
            assert isinstance(e, PagedSegmentCacheEntry)
            alive.append((ctx.round_idx, weakref.ref(e)))
            k, _ = gather_pages(e.pool_k, e.pool_v, e.page_idx, e.seq_len)
            prev = seen.get(a)
            if prev is not None:
                pool = eng.policy.hist_pools[eng.sessions[a].family]
                bt = pool.block_tokens
                old_k, dirty = prev
                keep = np.ones(old_k.shape[1] // bt, bool)
                keep[dirty] = False
                rows = np.repeat(keep, bt)
                assert torch.equal(k[:, :old_k.shape[1]][:, rows],
                                   old_k[:, rows]), a
            seen[a] = (k.clone(), [])
        return out

    orig_store = eng.policy._record_round_delta

    def spy_store(ctx, plan, hspan):
        orig_store(ctx, plan, hspan)
        pool = eng.policy.hist_pools.get(ctx.group_key)
        if pool is not None and pool.pending is not None:
            for a, blocks in pool.pending.dirty.items():
                seen[a] = (seen[a][0], list(blocks))

    eng.policy._restore_histories = spy
    eng.policy._record_round_delta = spy_store
    stats = eng.serve(trace)
    assert [bool(_infos(s) and _infos(s)[0]["incremental"])
            for s in stats] == [False, False, True, True]
    del stats
    gc.collect()
    assert all(w() is None for _, w in alive)


# ------------------------------------------------ golden committee trace
def test_four_round_committee_parity(setup, jax_served):
    """A 4-round committee trace (grouped committees of 2: a two-agent
    family and a singleton side by side): incremental == full == dense
    bit for bit every round, the two restores describe the same work and
    only the delta is redone from round 2, and everything equals the JAX
    engine's."""
    case = dict(n_agents=3, n_rounds=4, seed=11, topology="grouped2")
    _, stats = _run_case(setup, **case)
    inc, full = stats["inc"], stats["full"]
    shared_keys = ("paged", "n_restored", "n_mirrors", "nb",
                   "full_write_pages", "page_bytes", "dense_equiv_bytes")
    for r in range(1, 4):
        ri, rf = _infos(inc[r]), _infos(full[r])
        assert len(ri) == len(rf) == 2
        for a, b in zip(ri, rf):
            for k in shared_keys:
                assert a[k] == b[k], (r, k, a, b)
            if r == 1:
                assert a == b, (r, a, b)
            else:
                assert a["incremental"] and not b["incremental"], (r, a, b)
                assert a["pool_pages"] < b["pool_pages"], (r, a, b)
                assert a["pages_reused"] > 0, (r, a)
    _assert_matches_jax(inc, jax_served(**case))


# ------------------------------------------------ the zero-argument engine
def test_default_engine_restore_ledger_equals_jax(setup, jax_engine):
    """``ServingEngine(params, cfg)`` runs the JAX default,
    ``TokenDancePolicy(paged_history=True, paged_attention=True,
    incremental=True)``: on the 8-agent ``agent_society`` trace its round-2
    restore is incremental and its ledgers, tokens and logits equal the
    JAX engine's."""
    cfg, params, tcfg, tparams = setup
    teng = ServingEngine(tparams, tcfg, keep_logits=True)
    pol = teng.policy
    assert isinstance(pol, TokenDancePolicy)
    assert (pol.paged_history, pol.paged_attention, pol.incremental) == \
        (True, True, True)
    ts = teng.serve(generate_trace("agent_society", 8, 3, tcfg.vocab_size,
                                   seed=0, jitter_hist=False))
    js = jax_engine(JaxTokenDance(), keep_logits=True).serve(
        jax_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                  jitter_hist=False))
    _assert_matches_jax(ts, js)
    r2 = ts[2].reuse["restore"]
    assert r2["incremental"] is True and r2["pages_reused"] > 0
    assert r2["pool_pages"] < r2["full_write_pages"]
