"""The vLLM prefix-caching baseline in the port: ``transformer.extend``
(chunked prefill through the prefill kernel) and ``PrefixCachePolicy``,
against the JAX package on the same weights and trace (smoke qwen2.5-7b,
f32 unless stated, ``agent_society`` 3 agents x 3 rounds, seed 11, gen 32),
plus the engine's mode-string front door (``MODES``,
``MultiAgentEngine``), its pool arguments and ``block_select=0``."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.transformer import extend as jax_extend
from repro.serving import MODES as JAX_MODES
from repro.serving import ServingEngine
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import extend, from_jax, prefill
from repro_torch.models.transformer import decode_step_paged
from repro_torch.serving import (MODES, POLICIES, MultiAgentEngine,
                                 PrefixCachePolicy, get_policy)
from repro_torch.serving import ServingEngine as TorchEngine

torch.set_num_threads(1)

N_AGENTS, N_ROUNDS, GEN = 3, 3, 32
KW = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
TRACE = dict(seed=11, jitter_hist=False)
# two bf16 ulps at the logits' magnitude (|logit| < 2), as in
# tests/test_torch_serving.py
BF16_TOL = 2.0 ** -6


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return np.asarray(x).tolist()


@pytest.fixture(scope="module")
def weights():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _jax_trace(cfg, n_rounds=N_ROUNDS):
    return generate_trace("agent_society", N_AGENTS, n_rounds,
                          cfg.vocab_size, **TRACE)


def _torch_trace(tcfg, n_rounds=N_ROUNDS):
    return torch_trace("agent_society", N_AGENTS, n_rounds, tcfg.vocab_size,
                       **TRACE)


# ------------------------------------------------------------- extend
def test_extend_matches_jax(weights):
    """B 2, a prefix of 20 prefilled into a cache of 40 rows, then 12
    tokens extended: logits within 3e-5 / 1e-4 of JAX's, the rows
    written within the same tolerance, the rows past 32 untouched, and
    ``length`` 32 in both."""
    cfg, params, tcfg, tparams = weights
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    _, jc = jax_prefill(params, cfg, toks[:, :20], max_len=40)
    jl, jc = jax_extend(params, cfg, toks[:, 20:], jc)
    tt = torch.as_tensor(toks)
    _, tc = prefill(tparams, tcfg, tt[:, :20], max_len=40)
    tl, tc2 = extend(tparams, tcfg, tt[:, 20:], tc)
    assert tl.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-5,
                               rtol=1e-4)
    for key in ("k", "v"):
        got, want = tc2[key].numpy(), np.asarray(jc[key])
        np.testing.assert_allclose(got[:, :, :32], want[:, :, :32],
                                   atol=3e-5, rtol=1e-4)
        assert not got[:, :, 32:].any() and not want[:, :, 32:].any()
        # written in place, as decode_step writes its cache
        assert tc2[key] is tc[key]
    assert tc2["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [32, 32]


def test_prefill_then_extend_equals_prefill(weights):
    """Inside the port: a prefill of 20 tokens extended by 12 gives the
    full prefill's logits at those positions and its cache."""
    _, _, tcfg, tparams = weights
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, tcfg.vocab_size, (2, 32), generator=g,
                         dtype=torch.int32)
    full_logits, full = prefill(tparams, tcfg, toks)
    _, cache = prefill(tparams, tcfg, toks[:, :20], max_len=32)
    logits, cache = extend(tparams, tcfg, toks[:, 20:], cache)
    torch.testing.assert_close(logits, full_logits[:, 20:], atol=3e-5,
                               rtol=1e-4)
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key], full[key], atol=3e-5,
                                   rtol=1e-4)
    assert torch.equal(cache["length"], full["length"])


def test_extend_refuses_ssm_state():
    """An SSM or hybrid model has no attention-only cache to extend; JAX
    asserts, the port raises ValueError."""
    tcfg = torch_smoke("hymba-1.5b")
    with pytest.raises(ValueError, match="SSM"):
        extend({}, tcfg, torch.zeros((1, 2), dtype=torch.int32),
               {"length": torch.zeros(1, dtype=torch.int32)})
    cfg = get_smoke_config("hymba-1.5b")
    with pytest.raises(AssertionError, match="SSM"):
        jax_extend({}, cfg, np.zeros((1, 2), np.int32), {})


# --------------------------------------------------------- prefix serve
@pytest.fixture(scope="module")
def served(weights):
    """Both engines with the prefix policy. Each store of the port is
    checked against the session tensors the previous store left: equal
    bits, so nothing wrote into them in place in between."""
    cfg, params, tcfg, tparams = weights
    jeng = ServingEngine(params, cfg, "prefix", **KW)
    js = jeng.serve(_jax_trace(cfg))
    teng = TorchEngine(tparams, tcfg, "prefix", **KW)
    store = teng.policy.store
    kept, checked = {}, []

    def checked_store(*args, **kw):
        for a, (k, v, kc, vc) in kept.items():
            s = teng.sessions[a]
            assert s.dense_k is k and s.dense_v is v, a
            assert torch.equal(k, kc) and torch.equal(v, vc), a
            checked.append(a)
        store(*args, **kw)
        for a, s in teng.sessions.items():
            kept[a] = (s.dense_k, s.dense_v, s.dense_k.clone(),
                       s.dense_v.clone())

    teng.policy.store = checked_store
    ts = teng.serve(_torch_trace(tcfg))
    del teng.policy.store
    return jeng, js, teng, ts, checked


def test_prefix_outputs_and_logits_equal_jax(served):
    """Greedy tokens equal every round; first-token logits within 2e-4
    (XLA and torch sum the same f32 products in another order)."""
    _, js, _, ts, _ = served
    assert len(ts) == N_ROUNDS
    for r in range(N_ROUNDS):
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=2e-4, rtol=0)


def test_prefix_ledgers_and_bytes_equal_jax(served):
    """Reuse and pool ledgers, persistent and transient bytes and the
    prompt lengths equal JAX's; rounds 1 and 2 reuse 192 and 224 prompt
    tokens."""
    jeng, js, teng, ts, _ = served
    for r in range(N_ROUNDS):
        want = {k: v for k, v in js[r].reuse.items() if k != "plan"}
        assert _plain(ts[r].reuse) == _plain(want), r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r
        assert ts[r].transient_peak_bytes == js[r].transient_peak_bytes, r
        assert ts[r].prompt_len == js[r].prompt_len, r
        assert ts[r].mode == js[r].mode == "prefix"
    assert [s.prompt_len for s in ts] == [224, 352, 384]
    assert [s.reuse.get("prefix_len") for s in ts] == [None, 192, 224]
    assert sorted(teng.pool.owners()) == sorted(jeng.pool.owners())
    assert teng.mode == jeng.mode == "prefix"


def test_prefix_sessions_own_their_storage(served):
    """Each session's dense K and V is a tensor of its own storage (no
    view of the round's cache, so a spill frees what the ledger says),
    and no store found a session tensor written in place since the
    previous store."""
    jeng, _, teng, _, checked = served
    ptrs = []
    for a, s in teng.sessions.items():
        for t in (s.dense_k, s.dense_v):
            assert t.untyped_storage().nbytes() == t.numel() * \
                t.element_size(), a
            ptrs.append(t.untyped_storage().data_ptr())
        js = jeng.sessions[a]
        assert tuple(s.dense_k.shape) == tuple(js.dense_k.shape)
        np.testing.assert_array_equal(s.prompt_tokens, js.prompt_tokens)
    assert len(set(ptrs)) == 2 * N_AGENTS
    assert len(checked) == (N_ROUNDS - 1) * N_AGENTS


def test_prefix_session_spill_round_trips(served):
    """A session spilled to the host tier and reloaded keeps its bits;
    the spill moves exactly that session's tensors."""
    _, _, teng, _, _ = served
    s = teng.sessions["agent0"]
    k, v = s.dense_k.clone(), s.dense_v.clone()
    other = teng.sessions["agent1"].dense_k
    assert teng.manager.spill("sess:agent0")
    assert "sess:agent0" in teng.manager.host
    teng.manager.ensure_resident("sess:agent0")
    assert torch.equal(s.dense_k, k) and torch.equal(s.dense_v, v)
    assert teng.sessions["agent1"].dense_k is other
    teng.manager.check()


# ---------------------------------------------------------------- bf16
@pytest.fixture(scope="module")
def served_bf16():
    """Both engines in bf16. The JAX prefix path stays bf16 end to end
    (extend over a bf16 session cache, then a bf16 decode), so the JAX
    engine serves as it is. The port is teacher-forced with the JAX
    tokens, so every round's prompts stay identical even where a near
    tie flips a greedy choice; each of the port's own choices is
    recorded with its logits."""
    cfg = get_smoke_config("qwen2.5-7b")
    assert cfg.dtype == "bfloat16"
    params = jax_init(jax.random.PRNGKey(0), cfg)
    jeng = ServingEngine(params, cfg, "prefix", **KW)
    js = jeng.serve(_jax_trace(cfg))
    tcfg = torch_smoke("qwen2.5-7b")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    teng = TorchEngine(tparams, tcfg, "prefix", **KW)
    choices = []
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
    ts = teng.serve(_torch_trace(tcfg))
    return jeng, js, teng, ts, choices


def test_bf16_prefix_stored_kv_dtype_equals_jax(served_bf16):
    jeng, js, teng, ts, _ = served_bf16
    for a, s in teng.sessions.items():
        assert s.dense_k.dtype == s.dense_v.dtype == torch.bfloat16
        assert str(jeng.sessions[a].dense_k.dtype) == "bfloat16"
    assert [s.reuse.get("prefix_len") for s in ts] == \
        [s.reuse.get("prefix_len") for s in js]
    assert [s.persistent_bytes for s in ts] == \
        [s.persistent_bytes for s in js]


def test_bf16_prefix_first_logits_close(served_bf16):
    _, js, _, ts, _ = served_bf16
    for r in range(N_ROUNDS):
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=BF16_TOL, rtol=0,
                                   err_msg=f"round {r}")


def test_bf16_prefix_greedy_choices_equal_outside_near_ties(served_bf16):
    """At every step the port's own greedy choice equals the JAX token,
    or the flip is a near tie: the port scores its choice at most
    2 * BF16_TOL above the JAX token."""
    _, js, _, _, choices = served_bf16
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


# ------------------------------------------------------- block_select=0
@pytest.mark.parametrize("mode", ["prefix", "recompute"])
def test_block_select_zero_serves_as_jax(weights, mode):
    """Unaligned prompts (217 / 348 / 380) through the dense decode loop
    (``flash_decode``): tokens and ledgers equal to JAX's."""
    cfg, params, tcfg, tparams = weights
    js = ServingEngine(params, cfg, mode, block_select=0, **KW).serve(
        _jax_trace(cfg))
    teng = TorchEngine(tparams, tcfg, mode, block_select=0, **KW)
    assert not teng._paged_decode_ok({"k": None}, 217)
    ts = teng.serve(_torch_trace(tcfg))
    assert [s.prompt_len for s in ts] == [s.prompt_len for s in js] == \
        [217, 348, 380]
    for r in range(N_ROUNDS):
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=2e-4, rtol=0)
        want = {k: v for k, v in js[r].reuse.items() if k != "plan"}
        assert _plain(ts[r].reuse) == _plain(want), r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r


@pytest.mark.parametrize("mode", ["tokendance", "pic"])
def test_block_select_zero_refused_for_block_policies(weights, mode):
    """The JAX engine takes the configuration and raises
    ZeroDivisionError at round 1's plan (the first reuse plan; a fault
    of the reference); the port refuses it at construction with a
    ValueError (a deliberate departure)."""
    cfg, params, tcfg, tparams = weights
    jeng = ServingEngine(params, cfg, mode, block_select=0, **KW)
    with pytest.raises(ZeroDivisionError):
        jeng.serve(_jax_trace(cfg, 2))
    assert jeng.round_idx == 1
    with pytest.raises(ValueError, match="block_select > 0"):
        TorchEngine(tparams, tcfg, mode, block_select=0, **KW)


def test_block_select_zero_hybrid_falls_back_to_recompute():
    """An SSM or hybrid model serves with the recompute policy whatever
    is asked for, so ``block_select=0`` constructs for it."""
    from repro_torch.models import init_params

    tcfg = torch_smoke("hymba-1.5b").replace(dtype="float32")
    eng = TorchEngine(init_params(tcfg, 0, device="cpu"), tcfg,
                      "tokendance", block_select=0)
    assert eng.mode == "recompute"


# ----------------------------------------------------- mode strings
def test_registry_round_trips_every_mode():
    assert MODES == JAX_MODES == ("recompute", "prefix", "pic", "tokendance")
    assert sorted(POLICIES) == sorted(MODES)
    for mode in MODES:
        pol = get_policy(mode)
        assert pol.name == mode and type(pol) is POLICIES[mode]
    assert isinstance(get_policy("prefix"), PrefixCachePolicy)
    with pytest.raises(KeyError):
        get_policy("nope")


@pytest.mark.parametrize("mode", MODES)
def test_multi_agent_engine_equals_serving_engine(weights, mode):
    """The deprecated shim warns and serves bit-equal to
    ``ServingEngine(get_policy(mode))``: outputs, first-token logits and
    ledgers."""
    _, _, tcfg, tparams = weights
    with pytest.warns(DeprecationWarning, match="deprecated"):
        shim = MultiAgentEngine(tparams, tcfg, mode, **KW)
    assert shim.mode == mode
    got = shim.serve(_torch_trace(tcfg, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        want = TorchEngine(tparams, tcfg, get_policy(mode), **KW).serve(
            _torch_trace(tcfg, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.outputs, w.outputs)
        np.testing.assert_array_equal(g.first_logits, w.first_logits)
        assert _plain(g.reuse) == _plain(w.reuse)
        assert g.persistent_bytes == w.persistent_bytes
    if mode == "tokendance":
        with pytest.warns(DeprecationWarning):
            pol = MultiAgentEngine(tparams, tcfg, mode, incremental=False,
                                   paged_history=False).policy
        assert not pol.incremental and not pol.paged_history


@pytest.mark.parametrize("kw", [{}, {"host_offload": False},
                                {"eviction": "lru"},
                                {"host_offload": False, "eviction": "lru"}])
def test_pool_arguments_construct_the_jax_manager(weights, kw):
    cfg, params, tcfg, tparams = weights
    jm = ServingEngine(params, cfg, **kw).manager
    tm = TorchEngine(tparams, tcfg, **kw).manager
    assert tm.host.capacity_bytes == jm.host.capacity_bytes
    assert type(tm.eviction).__name__ == type(jm.eviction).__name__


def test_keep_recovered_equals_jax(weights):
    """``keep_recovered`` keeps each round's recovered KV as host copies
    with the layouts, as JAX keeps numpy arrays."""
    cfg, params, tcfg, tparams = weights
    jeng = ServingEngine(params, cfg, "prefix", keep_recovered=True, **KW)
    jeng.serve(_jax_trace(cfg, 2))
    teng = TorchEngine(tparams, tcfg, "prefix", keep_recovered=True, **KW)
    teng.serve(_torch_trace(tcfg, 2))
    (tk, tv, tl), (jk, jv, jl) = teng.last_recovered, jeng.last_recovered
    assert tk.device.type == "cpu" and tk.shape == jk.shape
    np.testing.assert_allclose(tk.numpy(), jk, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), jv, atol=3e-5, rtol=1e-4)
    assert [list(x.tokens) for x in tl] == [list(x.tokens) for x in jl]
    assert TorchEngine(tparams, tcfg).last_recovered is None
