"""The slice end to end: the port's ``ServingEngine`` with
``TokenDancePolicy(incremental=False)`` against the JAX engine with the
same policy, on the same weights and trace (smoke qwen2.5-7b in f32, 3
agents, 3 rounds, seed 11, gen 32, recompute_ratio 0.1), and the same
run in bf16."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params as jax_init
from repro.models import transformer as jax_tf
from repro.serving import ServingEngine, TokenDancePolicy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import from_jax, init_params
from repro_torch.models.transformer import decode_step_paged
from repro_torch.serving import ServingEngine as TorchEngine
from repro_torch.serving import TokenDancePolicy as TorchTokenDance

torch.set_num_threads(1)

N_AGENTS, N_ROUNDS, GEN = 3, 3, 32
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
    jeng = ServingEngine(params, cfg, TokenDancePolicy(incremental=False),
                         **kw)
    js = jeng.serve(generate_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                   cfg.vocab_size, seed=11,
                                   jitter_hist=False))
    teng = TorchEngine(tparams, tcfg, TorchTokenDance(incremental=False),
                       **kw)
    ts = teng.serve(torch_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                tcfg.vocab_size, seed=11, jitter_hist=False))
    return jeng, js, teng, ts


def test_outputs_equal_jax_every_round(served):
    _, js, _, ts = served
    assert len(js) == len(ts) == N_ROUNDS
    for r in range(N_ROUNDS):
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)


def test_first_token_logits_close(served):
    """atol 2e-4: XLA and torch sum the same f32 products in another order
    over 4 layers (the port's attention is a different kernel form, too);
    the greedy tokens above are equal."""
    _, js, _, ts = served
    for r in range(N_ROUNDS):
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=2e-4, rtol=0)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return np.asarray(x).tolist()


def test_reuse_and_pool_ledgers_equal(served):
    jeng, js, teng, ts = served
    for r in range(N_ROUNDS):
        want = {k: v for k, v in js[r].reuse.items() if k != "plan"}
        assert _plain(ts[r].reuse) == _plain(want), r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r
        assert ts[r].transient_peak_bytes == js[r].transient_peak_bytes, r
        assert ts[r].prompt_len == js[r].prompt_len, r
    restore = ts[-1].reuse["restore"]
    assert restore["paged"] and not restore["incremental"]
    assert restore["pool_pages"] <= restore["full_write_pages"]
    assert ts[-1].reuse["pool"]["restore_cache_bytes"] == 0
    assert teng.collector.align_passes == jeng.collector.align_passes


# ------------------------------------------------------------------ bf16
# The JAX engine assembles the cached KV in f32 whatever the model dtype,
# so a bf16 model's recovery — and the KV it stores — is f32 there by
# jnp promotion; the port follows. Logits agree within two bf16 ulps at
# their magnitude (|logit| < 2): round 0 prefills and decodes in bf16 in
# both packages, which round the same f32 sums at other points.
BF16_TOL = 2.0 ** -6


def _jax_decode_step_paged_unscanned(params, cfg, token, cache):
    """``repro.models.decode_step_paged`` with its layer loop written out
    in Python. The JAX step carries the residual stream through
    ``lax.scan``, which refuses a carry whose dtype changes: over the f32
    KV recovery stores, a bf16 model's stream promotes to f32 at the
    first attention, so the JAX engine raises TypeError from round 1 on.
    The per-layer function is the JAX package's own."""
    B = token.shape[0]
    h = jnp.take(params["embed"], token[:, None], axis=0).astype(
        jax_tf._dtype(cfg)).reshape(B, 1, -1)
    length = cache["length"]
    positions = length[:, None]
    cos, sin = jax_tf.rope_cos_sin(positions, cfg.resolved_head_dim,
                                   cfg.rope_theta)
    page_idx = cache["page_idx"]
    kv_pos = jax.vmap(lambda p_, i: jax.lax.dynamic_update_slice(
        p_, i[None], (i,)))(cache["kv_pos"], length)
    kv_valid = jax.vmap(lambda v_, i: jax.lax.dynamic_update_slice(
        v_, jnp.ones((1,), bool), (i,)))(cache["kv_valid"], length)
    windows = jax_tf._windows(cfg, page_idx.shape[1] * cache["pk"].shape[2],
                              False)
    pks, pvs = [], []
    for l in range(cfg.n_layers):
        lc = {"pk": cache["pk"][l], "pv": cache["pv"][l], "length": length,
              "kv_pos": kv_pos, "kv_valid": kv_valid, "page_idx": page_idx}
        h, out = jax_tf._block_decode_paged(
            h, jax.tree.map(lambda a: a[l], params["blocks"]), cfg,
            window=windows[l], positions=positions, cos=cos, sin=sin,
            shard=jax_tf._noshard, layer_cache=lc)
        pks.append(out["pk"])
        pvs.append(out["pv"])
    new_cache = dict(cache, pk=jnp.stack(pks), pv=jnp.stack(pvs),
                     kv_pos=kv_pos, kv_valid=kv_valid, length=length + 1)
    return jax_tf._logits(params, cfg, h, jax_tf._noshard)[:, 0], new_cache


@pytest.fixture(scope="module")
def served_bf16():
    """Both engines in bf16. The port is teacher-forced with the JAX
    tokens, so every round's prompts stay identical even where a near
    tie flips a greedy choice; each of the port's own greedy choices is
    recorded with its logits."""
    import repro.serving.engine as jax_engine

    cfg = get_smoke_config("qwen2.5-7b")
    assert cfg.dtype == "bfloat16"
    params = jax_init(jax.random.PRNGKey(0), cfg)
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
    trace = dict(seed=11, jitter_hist=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "decode_step_paged",
                   _jax_decode_step_paged_unscanned)
        jeng = ServingEngine(params, cfg, TokenDancePolicy(incremental=False),
                             **kw)
        js = jeng.serve(generate_trace("generative_agents", N_AGENTS,
                                       N_ROUNDS, cfg.vocab_size, **trace))
    tcfg = torch_smoke("qwen2.5-7b")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    teng = TorchEngine(tparams, tcfg, TorchTokenDance(incremental=False),
                       **kw)
    choices = []        # (round, step, own greedy tokens [N], logits [N, V])
    begin = teng._decode_begin

    def forced_begin(first_logits, cache, N, S, gaids, use_paged):
        assert use_paged
        st = begin(first_logits, cache, N, S, gaids, use_paged)
        r = teng.round_idx
        want = torch.as_tensor(js[r].outputs, dtype=torch.int32)
        choices.append((r, 0, st.tok, first_logits.float()))
        st.tok = want[:, 0].clone()
        st.outs = [st.tok]

        def step(tok, cache, _st=st):
            logits, cache = decode_step_paged(tparams, tcfg, tok, cache)
            t = _st.t + 1
            choices.append((r, t, logits.argmax(-1).to(torch.int32),
                            logits.float()))
            return want[:, t].clone(), cache

        st.step = step
        return st

    teng._decode_begin = forced_begin
    ts = teng.serve(torch_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                tcfg.vocab_size, **trace))
    return jeng, js, teng, ts, choices


def test_bf16_stored_kv_dtype_equals_jax(served_bf16):
    """The recovered KV (the Masters built from it) is f32 in both, and
    the output segments have the same dtypes (round 0's are bf16)."""
    jeng, _, teng, _, _ = served_bf16
    jm = [str(m.k.dtype) for m in jeng.policy.masters.values()]
    tm = [str(m.k.dtype).removeprefix("torch.")
          for m in teng.policy.masters.values()]
    assert tm == jm == ["float32"], (tm, jm)

    def seg_dtypes(eng, strip):
        return sorted(str(e.k.dtype).removeprefix(strip)
                      for e in eng.segment_index._entries.values())

    assert seg_dtypes(teng, "torch.") == seg_dtypes(jeng, "")


def test_bf16_first_token_logits_close(served_bf16):
    _, js, _, ts, _ = served_bf16
    for r in range(N_ROUNDS):
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=BF16_TOL, rtol=0,
                                   err_msg=f"round {r}")


def test_bf16_greedy_tokens_equal_outside_near_ties(served_bf16):
    """The first token equals JAX's wherever JAX's top-2 gap exceeds
    2 * BF16_TOL. At every step the port's own greedy choice equals the
    JAX token, or the flip is a near tie: the port scores its choice at
    most 2 * BF16_TOL above the JAX token (logits within BF16_TOL of
    each other cannot order two tokens further apart)."""
    _, js, _, ts, choices = served_bf16
    for r in range(N_ROUNDS):
        top2 = np.sort(js[r].first_logits, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL
        own = ts[r].first_logits.argmax(axis=1)
        want = js[r].first_logits.argmax(axis=1)
        assert (own[clear] == want[clear]).all(), (r, own, want)
    assert len(choices) == N_ROUNDS * GEN
    for r, t, own, logits in choices:
        want = js[r].outputs[:, t]
        for a in range(N_AGENTS):
            if own[a] == want[a]:
                continue
            gap = float(logits[a, own[a]] - logits[a, int(want[a])])
            assert gap <= 2 * BF16_TOL, (
                f"round {r}, agent {a}, step {t}: port picks {int(own[a])},"
                f" JAX {int(want[a])}, port logit gap {gap} is no near tie")


def test_bf16_jax_engine_decode_scan_refuses_promoted_stream():
    """Why the fixture above unrolls the JAX decode step: served as it
    is, the JAX engine stops at round 1's first decode step for a bf16
    model (the recovered KV is f32, the scan's carry is bf16)."""
    cfg = get_smoke_config("qwen2.5-7b")
    eng = ServingEngine(jax_init(jax.random.PRNGKey(0), cfg), cfg,
                        TokenDancePolicy(incremental=False), gen_len=GEN,
                        recompute_ratio=0.1)
    trace = generate_trace("generative_agents", N_AGENTS, 2, cfg.vocab_size,
                           seed=11, jitter_hist=False)
    eng.init_agents(trace)
    eng.run_round(trace.rounds[0])
    with pytest.raises(TypeError, match="carry"):
        eng.run_round(trace.rounds[1])


def test_port_imports_no_jax_and_nothing_of_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_source_imports_neither_jax_nor_repro(path):
    """Static check of every import statement, including the ones inside
    functions that the subprocess test above never executes."""
    import ast

    tree = ast.parse((ROOT / path).read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (path, bad)


def test_entry_points_need_a_device_when_no_card():
    cfg = torch_smoke("qwen2.5-7b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    # the cross-round incremental restore is ported: the JAX default
    # constructs (tests/test_torch_histpool_engines.py serves it)
    assert TorchTokenDance().incremental
    # MoE is ported: init_params builds the moe leaves, where it once
    # raised NotImplementedError
    moe = init_params(cfg.replace(n_experts=4, top_k=2), 0,
                      device="cpu")["blocks"]
    assert "moe" in moe and "mlp" not in moe
    assert moe["moe"]["w_gate"].shape == (cfg.n_layers, 4, cfg.d_model,
                                          cfg.d_ff)


# ------------------------------------------------------------ serve(...)
# Both engines take serve(trace, planner=None, n_rounds=None): a caller
# that passes n_rounds positionally hands it over as the planner, and the
# first plan_round call raises in both packages.
@pytest.fixture(scope="module")
def positional():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)

    def trace(gen, vocab):
        return gen("generative_agents", N_AGENTS, N_ROUNDS, vocab, seed=11,
                   jitter_hist=False)

    return (lambda: ServingEngine(params, cfg, **kw),
            lambda: TorchEngine(tparams, tcfg, **kw),
            lambda: trace(generate_trace, cfg.vocab_size),
            lambda: trace(torch_trace, tcfg.vocab_size))


def _assert_rounds_equal(ts, js):
    assert len(ts) == len(js)
    for r, (t, j) in enumerate(zip(ts, js)):
        np.testing.assert_array_equal(t.outputs, j.outputs, err_msg=str(r))
        want = {k: v for k, v in j.reuse.items() if k != "plan"}
        assert _plain(t.reuse) == _plain(want), r
        assert t.persistent_bytes == j.persistent_bytes, r
        assert t.transient_peak_bytes == j.transient_peak_bytes, r
        assert t.admission == j.admission, r


def test_serve_positional_arguments_equal_jax(positional):
    """``serve(trace, None, 2)`` serves two rounds in both packages with
    equal tokens and ledgers, as ``run_trace(trace, 2)`` does in the
    port; ``serve(trace, 2)`` passes 2 as the planner and raises in
    both."""
    jax_eng, torch_eng, jax_tr, torch_tr = positional
    js = jax_eng().serve(jax_tr(), None, 2)
    ts = torch_eng().serve(torch_tr(), None, 2)
    assert len(ts) == 2
    _assert_rounds_equal(ts, js)
    _assert_rounds_equal(torch_eng().run_trace(torch_tr(), 2), js)
    for make, tr in ((jax_eng, jax_tr), (torch_eng, torch_tr)):
        with pytest.raises(AttributeError, match="plan_round"):
            make().serve(tr(), 2)


class _DeferLast:
    """A planner stub: admits every agent but defers the last one in
    round 1, and records each call the engine makes."""

    def __init__(self, plan_cls):
        self.plan_cls, self.calls = plan_cls, []

    def plan_round(self, round_idx, agent_ids):
        self.calls.append(("plan", round_idx, list(agent_ids)))
        cut = agent_ids[-1:] if round_idx == 1 else []
        return self.plan_cls(round_idx,
                             [a for a in agent_ids if a not in cut], cut)

    def observe(self, stats, collective):
        self.calls.append(("observe", stats.round_idx, collective))


def test_serve_asks_the_planner_as_jax_does(positional):
    """The lookahead order (plan r+1 before round r runs, observe r
    after), the admission each round records, and the served tokens and
    ledgers are those of the JAX engine under the same planner."""
    from repro.serving.planner import RoundPlan as JaxPlan
    from repro_torch.serving.planner import RoundPlan as TorchPlan

    jax_eng, torch_eng, jax_tr, torch_tr = positional
    jp, tp = _DeferLast(JaxPlan), _DeferLast(TorchPlan)
    js = jax_eng().serve(jax_tr(), jp)
    ts = torch_eng().serve(torch_tr(), tp)
    assert tp.calls == jp.calls
    assert [c[:2] for c in tp.calls[:4]] == [
        ("plan", 0), ("plan", 1), ("observe", 0), ("plan", 2)]
    assert ts[1].admission["deferred"] == [tp.calls[0][2][-1]]
    _assert_rounds_equal(ts, js)


# ------------------------------------------------ persistent footprint
def test_persistent_bytes_equal_jax_and_survive_spill(served):
    """``_persistent_bytes`` as JAX's after the same trace; spilling a
    persistent store owner moves its bytes to the host tier and keeps the
    sum (the counterpart of ``test_persistent_bytes_survive_spill``)."""
    from repro_torch.serving.pool import parse_owner

    jeng, js, teng, ts = served
    total = teng._persistent_bytes()
    assert total == jeng._persistent_bytes() == ts[-1].persistent_bytes
    dev0, host0, cache0 = teng._persistent_split()
    assert total == dev0 + host0 and dev0 > 0
    victim = next(o for o in teng.manager._spillables
                  if o in teng.pool._allocs
                  and teng.pool._allocs[o].persistent
                  and parse_owner(o).kind != "histpool")
    n_pages = teng.pool._allocs[victim].n_pages
    assert teng.manager.spill(victim)
    dev1, host1, cache1 = teng._persistent_split()
    assert teng._persistent_bytes() == total
    assert host1 == host0 + n_pages * teng.pool.page_bytes()
    assert dev1 == dev0 - n_pages * teng.pool.page_bytes()
    assert cache1 == cache0
    teng.manager.ensure_resident(victim)      # reload: as before
    assert teng._persistent_split() == (dev0, host0, cache0)


# ------------------------------------------- the prefix policy on Hymba
# The inputs that show the fault: smoke hymba-1.5b in f32, agent_society,
# 3 agents, 2 rounds, seed 11, gen 32, ratio 0.1.
def _hymba_prefix_inputs():
    cfg = get_smoke_config("hymba-1.5b").replace(dtype="float32")
    trace = generate_trace("agent_society", 3, 2, cfg.vocab_size, seed=11,
                           jitter_hist=False)
    return cfg, trace


def test_jax_prefix_engine_on_hybrid_fails_at_round_1():
    """A fault of the reference, pinned as it is: the JAX engine keeps the
    prefix policy for Hymba (``requires_attention`` is False), round 0
    recomputes and stores dense sessions, and round 1's ``extend``
    asserts an attention-only cache."""
    cfg, trace = _hymba_prefix_inputs()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    eng = ServingEngine(params, cfg, "prefix", gen_len=GEN,
                        recompute_ratio=0.1)
    assert eng.policy.name == "prefix"
    eng.init_agents(trace)
    st = eng.run_round(trace.rounds[0])
    assert st.outputs.shape == (3, GEN)
    with pytest.raises(AssertionError, match="extend"):
        eng.run_round(trace.rounds[1])


def test_port_prefix_engine_refuses_hybrid_at_construction():
    """A deliberate departure: the port refuses the prefix policy on an
    SSM or hybrid model before any work (``requires_attention_cache``),
    through every engine front door; the recompute fallback of the
    PIC-style policies is unchanged."""
    from repro_torch.configs import get_smoke_config as smoke
    from repro_torch.serving import (ContinuousEngine, MultiAgentEngine,
                                     PrefixCachePolicy, get_policy)

    tcfg = smoke("hymba-1.5b").replace(dtype="float32")
    tparams = init_params(tcfg, 0, device="cpu")
    assert PrefixCachePolicy.requires_attention_cache
    assert not any(get_policy(m).requires_attention_cache
                   for m in ("recompute", "pic", "tokendance"))
    for make in (lambda: TorchEngine(tparams, tcfg, "prefix"),
                 lambda: TorchEngine(tparams, tcfg, PrefixCachePolicy()),
                 lambda: ContinuousEngine(tparams, tcfg, "prefix")):
        with pytest.raises(ValueError, match="SSM state"):
            make()
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="SSM state"):
        MultiAgentEngine(tparams, tcfg, "prefix")
    assert TorchEngine(tparams, tcfg, "tokendance").policy.name == \
        "recompute"
    # an attention-only model keeps the policy
    qcfg = smoke("qwen3-4b").replace(dtype="float32")
    assert TorchEngine(init_params(qcfg, 0, device="cpu"), qcfg,
                       "prefix").policy.name == "prefix"


# ------------------------------------------------ engines free their weights
def test_del_engine_frees_its_weights_without_the_collector():
    """With the cyclic collector off, ``del`` of a served ``ServingEngine``
    or ``ContinuousEngine`` and of the caller's ``params`` frees the
    weights at once: no reference cycle holds an engine (the continuous
    loop's scheduler calls back through a weak proxy)."""
    import gc
    import weakref

    from repro_torch.core.rounds import SubsetGather
    from repro_torch.serving import ContinuousEngine

    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    trace = torch_trace("generative_agents", 4, 1, tcfg.vocab_size, seed=11,
                        jitter_hist=False)
    aids = list(trace.agent_ids)
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        for kind in ("serving", "continuous"):
            params = init_params(tcfg, 0, device="cpu")
            refs = [weakref.ref(t) for t in (
                params["embed"], params["lm_head"],
                params["blocks"]["attn"]["wq"])]
            if kind == "serving":
                engine = TorchEngine(params, tcfg, gen_len=GEN,
                                     recompute_ratio=0.1)
                st = engine.serve(trace)
            else:
                engine = ContinuousEngine(
                    params, tcfg, "tokendance",
                    topology=SubsetGather.grouped(aids, 2), gen_len=GEN,
                    recompute_ratio=0.1)
                st = engine.serve(trace, stagger=[0, 4]).stats
            assert len(st) >= 1
            del engine, params
            alive = [r() is not None for r in refs]
            assert not any(alive), (kind, alive)
    finally:
        if was:
            gc.enable()
