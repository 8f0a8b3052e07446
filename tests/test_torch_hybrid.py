"""Slice 3 end to end on the CPU: the Hymba-1.5B smoke model (attention
and Mamba2 heads in every layer, sliding window 64) and the engine's dense
decode loop, against the JAX package on the same weights (``from_jax``)
in f32 and in bf16 (the dtype it is served in), plus the port's own
paged == dense contract.

Tolerances: f32 logits atol 1e-4 (f32 sums in another order over two
layers and 40 decode steps; the greedy tokens are equal). bf16 logits atol
2^-6, two bf16 ulps at their magnitude (|logit| < 2): both packages round
the same f32 sums to bf16 at other points; a greedy choice may differ
only at a near tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import make_empty_cache as jax_empty
from repro.models import prefill as jax_prefill
from repro.serving import ServingEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, decode_step_paged, from_jax,
                                init_params, make_empty_cache, prefill)
from repro_torch.serving import DenseRoundKV, PagedRoundKV, get_policy
from repro_torch.serving import ServingEngine as TorchEngine
from repro_torch.serving import round_kv

torch.set_num_threads(1)

ATOL = 1e-4
BF16_TOL = 2.0 ** -6
N_AGENTS, N_ROUNDS, GEN = 3, 3, 32


@pytest.fixture(scope="module")
def hymba():
    cfg = get_smoke_config("hymba-1.5b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("hymba-1.5b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def test_config_copy_equals_jax():
    from repro.configs import get_config

    for tc, jc in ((torch_config("hymba-1.5b"), get_config("hymba-1.5b")),
                   (torch_smoke("hymba-1.5b"),
                    get_smoke_config("hymba-1.5b"))):
        assert tc.__dict__ == jc.__dict__
        assert (tc.d_inner, tc.ssm_heads) == (jc.d_inner, jc.ssm_heads)
        for n in (100, 1024, 5000):
            assert tc.layer_window_sizes(n) == jc.layer_window_sizes(n)


def test_from_jax_keeps_every_hybrid_leaf(hymba):
    _, params, _, tparams = hymba
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert any("ssm_out_norm" in str(p) for p, _ in flat)
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert str(node.dtype).endswith(str(np.asarray(leaf).dtype))
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_has_the_jax_tree(hymba):
    cfg, params, tcfg, _ = hymba
    mine = init_params(tcfg, 0, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).endswith(str(leaf.dtype)), path
    assert (mine["blocks"]["ssm"]["A_log"] > 0).all()


@pytest.mark.parametrize("S", [40, 100])
def test_prefill_and_decode_match_jax(hymba, S):
    """The window (64) binds in the 100-token prompt and not in the
    40-token one; 8 decode steps over the dense cache and SSM state."""
    cfg, params, tcfg, tparams = hymba
    B, G = 2, 8
    tokens = np.random.default_rng(S).integers(
        0, cfg.vocab_size - 1, (B, S)).astype(np.int32)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(tokens), max_len=S + G)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(tokens), max_len=S + G)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for key in ("k", "v", "ssm", "conv"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=0)
    assert tc["ssm"].dtype == torch.float32
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for _ in range(G):
        jlog, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlog, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                                   rtol=0)
        assert np.array_equal(tlog.numpy().argmax(-1),
                              np.asarray(jlog).argmax(-1))
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    for key in ("k", "v", "ssm", "conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=0)
    assert tc["length"].tolist() == [S + G] * B


def test_make_empty_cache_matches_jax(hymba):
    cfg, _, tcfg, _ = hymba
    jc = jax_empty(cfg, 3, 50)
    tc = make_empty_cache(tcfg, 3, 50, device="cpu")
    assert sorted(tc) == sorted(k for k in jc if k not in ("kv_pos",
                                                           "kv_valid"))
    for key, t in tc.items():
        assert tuple(t.shape) == jc[key].shape, key
        assert str(t.dtype).endswith(str(jc[key].dtype)), key
        assert not t.any()


def test_decode_from_an_empty_cache_matches_jax(hymba):
    """Decode from ``make_empty_cache``: the first step attends to its own
    row only and the SSM starts from zero state."""
    cfg, params, tcfg, tparams = hymba
    jc = jax_empty(cfg, 2, 16)
    tc = make_empty_cache(tcfg, 2, 16, device="cpu")
    tok = np.array([5, 7], np.int32)
    for _ in range(4):
        jlog, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlog, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                                   rtol=0)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)


def test_paged_decode_refuses_a_binding_window(hymba):
    """The paged decode kernel used to have no window, and a model whose
    window binds raised; now it decodes as the dense loop does on the same
    rows (its window of 64 binds over 96 rows of pages), and an SSM cache
    is still refused."""
    cfg, params, tcfg, tparams = hymba
    attn_only = tcfg.replace(arch_type="dense", hybrid=False, ssm_state=0)
    assert min(attn_only.layer_window_sizes(96)) < 96
    p = init_params(attn_only, 0, device="cpu")
    L, KV, hd = attn_only.n_layers, attn_only.n_kv_heads, 32
    g = torch.Generator().manual_seed(3)
    kv = torch.randn(2, L, 2, 96, KV, hd, generator=g)
    kv[..., 90:, :, :] = 0.0                 # rows past length + 1
    length = torch.full((2,), 89, dtype=torch.int32)
    cache = {"pk": kv[0].reshape(L, 6, 32, KV, hd).clone(),
             "pv": kv[1].reshape(L, 6, 32, KV, hd).clone(),
             "page_idx": torch.arange(6, dtype=torch.int32).reshape(2, 3),
             "length": length}
    dense = {"k": kv[0].clone(), "v": kv[1].clone(), "length": length}
    tok = torch.tensor([1, 2], dtype=torch.int32)
    got, _ = decode_step_paged(p, attn_only, tok, dict(cache))
    want, _ = decode_step(p, attn_only, tok, dense)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    logits, _ = decode_step_paged(p, attn_only.replace(sliding_window=96),
                                  tok, dict(cache))
    assert logits.shape == (2, attn_only.vocab_size)
    assert not torch.allclose(logits, got, atol=1e-4)
    with pytest.raises(ValueError):
        decode_step_paged(tparams, tcfg, tok, dict(cache))


def test_check_supported_admits_hybrid_and_refuses_the_rest():
    from repro_torch.models.layers import check_supported

    cfg = torch_smoke("hymba-1.5b")
    check_supported(cfg)
    check_supported(cfg.replace(hybrid=False, arch_type="ssm"))
    # qk_norm (layers.project_qkv) and tied embeddings
    # (transformer.logits_of) are ported; the rest still refuses
    check_supported(cfg.replace(qk_norm=True))
    check_supported(cfg.replace(tie_embeddings=True))
    for bad in (dict(n_experts=4, top_k=2), dict(attn_logit_softcap=30.0),
                dict(frontend="audio")):
        with pytest.raises(NotImplementedError):
            check_supported(cfg.replace(**bad))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def served(hymba):
    """Both engines asked for TokenDance on the hybrid model: both fall
    back to recompute and the dense decode loop."""
    cfg, params, tcfg, tparams = hymba
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
    jeng = ServingEngine(params, cfg, "tokendance", **kw)
    js = jeng.serve(generate_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                   cfg.vocab_size, seed=11,
                                   jitter_hist=False))
    teng = TorchEngine(tparams, tcfg, "tokendance", **kw)
    ops.reset_launches()
    ts = teng.serve(torch_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                tcfg.vocab_size, seed=11, jitter_hist=False))
    calls = dict(ops.PLAIN_CALLS)
    return jeng, js, teng, ts, calls


def test_engine_falls_back_to_recompute_and_dense_decode(served):
    jeng, _, teng, ts, calls = served
    assert jeng.policy.name == teng.policy.name == "recompute"
    assert all(st.mode == "recompute" for st in ts)
    assert calls["flash_decode"] == N_ROUNDS * (GEN - 1) * teng.cfg.n_layers
    assert calls["flash_decode_paged"] == 0


def test_engine_greedy_tokens_equal_jax(served):
    _, js, _, ts, _ = served
    assert len(ts) == len(js) == N_ROUNDS
    for r in range(N_ROUNDS):
        assert ts[r].prompt_len == js[r].prompt_len
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)


def test_engine_logits_close_to_jax(served):
    _, js, _, ts, _ = served
    for r in range(N_ROUNDS):
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=ATOL, rtol=0)


def test_engine_pool_ledgers_equal_jax(served):
    _, js, _, ts, _ = served
    for r in range(N_ROUNDS):
        assert ts[r].reuse == js[r].reuse, r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r
        assert ts[r].transient_peak_bytes == js[r].transient_peak_bytes, r


# ------------------------------------------------------------------ bf16
@pytest.fixture(scope="module")
def hymba_bf16():
    cfg = get_smoke_config("hymba-1.5b")
    tcfg = torch_smoke("hymba-1.5b")
    assert cfg.dtype == tcfg.dtype == "bfloat16"
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _assert_near_tie(own, want, logits, where):
    """The port's greedy choice ``own`` equals the JAX token ``want``, or
    the port scores it at most 2 * BF16_TOL above the JAX token (logits
    within BF16_TOL of JAX's cannot order two tokens further apart)."""
    for a in range(len(want)):
        if int(own[a]) == int(want[a]):
            continue
        gap = float(logits[a, int(own[a])] - logits[a, int(want[a])])
        assert gap <= 2 * BF16_TOL, (
            f"{where}, row {a}: port picks {int(own[a])}, JAX {int(want[a])},"
            f" port logit gap {gap} is no near tie")


@pytest.mark.parametrize("S", [40, 100])
def test_bf16_prefill_and_decode_match_jax(hymba_bf16, S):
    """The served dtype: KV and conv state bf16, SSM state f32 in both
    packages, each mixer's output RMS-normed before the 0.5 mix. The
    window (64) binds at S 100. Decode is teacher-forced with the JAX
    tokens so both packages see the same inputs at every step."""
    cfg, params, tcfg, tparams = hymba_bf16
    B, G = 2, 6
    tokens = np.random.default_rng(S).integers(
        0, cfg.vocab_size - 1, (B, S)).astype(np.int32)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(tokens), max_len=S + G)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(tokens), max_len=S + G)

    def caches_close():
        for key, dt in (("k", torch.bfloat16), ("v", torch.bfloat16),
                        ("conv", torch.bfloat16), ("ssm", torch.float32)):
            assert tc[key].dtype == dt, key
            assert str(dt).endswith(str(jc[key].dtype)), key
            # one bf16 ulp of the value (the JAX and port roundings differ)
            np.testing.assert_allclose(
                tc[key].float().numpy(), np.asarray(jc[key], np.float32),
                atol=BF16_TOL, rtol=2.0 ** -7, err_msg=key)

    caches_close()
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.float().numpy(), jl, atol=BF16_TOL, rtol=0)
    tok = jl[:, -1].argmax(-1).astype(np.int32)
    _assert_near_tie(tl[:, -1].argmax(-1), tok, tl[:, -1].float(), "prefill")
    for t in range(G):
        jlog, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlog, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        jlog = np.asarray(jlog, np.float32)
        np.testing.assert_allclose(tlog.float().numpy(), jlog, atol=BF16_TOL,
                                   rtol=0, err_msg=f"step {t}")
        tok = jlog.argmax(-1).astype(np.int32)
        _assert_near_tie(tlog.argmax(-1), tok, tlog.float(), f"step {t}")
    caches_close()
    assert tc["length"].tolist() == [S + G] * B


@pytest.fixture(scope="module")
def served_bf16(hymba_bf16):
    """Both engines on the bf16 hybrid model (recompute, dense decode).
    The port is teacher-forced with the JAX tokens, so every round's
    prompts stay identical even where a near tie flips a greedy choice;
    each of its own greedy choices is recorded with its logits."""
    cfg, params, tcfg, tparams = hymba_bf16
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
    trace = dict(seed=11, jitter_hist=False)
    jeng = ServingEngine(params, cfg, "tokendance", **kw)
    js = jeng.serve(generate_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                   cfg.vocab_size, **trace))
    teng = TorchEngine(tparams, tcfg, "tokendance", **kw)
    choices = []        # (round, step, own greedy tokens [N], logits [N, V])
    dtypes = []         # the decode cache's dtypes, per round
    begin = teng._decode_begin

    def forced_begin(first_logits, cache, N, S, gaids, use_paged):
        st = begin(first_logits, cache, N, S, gaids, use_paged)
        r = teng.round_idx
        dtypes.append({k: v.dtype for k, v in st.cache.items()})
        want = torch.as_tensor(js[r].outputs, dtype=torch.int32)
        choices.append((r, 0, st.tok, first_logits.float()))
        st.tok = want[:, 0].clone()
        st.outs = [st.tok]

        def step(tok, cache, _st=st):
            logits, cache = decode_step(tparams, tcfg, tok, cache)
            t = _st.t + 1
            choices.append((r, t, logits.argmax(-1).to(torch.int32),
                            logits.float()))
            return want[:, t].clone(), cache

        st.step = step
        return st

    teng._decode_begin = forced_begin
    ts = teng.serve(torch_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                tcfg.vocab_size, **trace))
    return jeng, js, teng, ts, choices, dtypes


def test_bf16_engine_decode_cache_dtypes(served_bf16):
    jeng, _, teng, _, _, dtypes = served_bf16
    assert jeng.policy.name == teng.policy.name == "recompute"
    assert dtypes == [dict(k=torch.bfloat16, v=torch.bfloat16,
                           conv=torch.bfloat16, ssm=torch.float32,
                           length=torch.int32)] * N_ROUNDS


def test_bf16_engine_first_token_logits_close(served_bf16):
    _, js, _, ts, _, _ = served_bf16
    for r in range(N_ROUNDS):
        assert ts[r].prompt_len == js[r].prompt_len
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=BF16_TOL, rtol=0,
                                   err_msg=f"round {r}")


def test_bf16_engine_greedy_tokens_equal_outside_near_ties(served_bf16):
    _, js, _, ts, choices, _ = served_bf16
    assert len(choices) == N_ROUNDS * GEN
    for r, t, own, logits in choices:
        _assert_near_tie(own, js[r].outputs[:, t], logits,
                         f"round {r}, step {t}")
    for r in range(N_ROUNDS):
        assert ts[r].reuse == js[r].reuse, r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r


# --------------------------------------------------- paged == dense (port)
@pytest.fixture(scope="module")
def qwen():
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    return tcfg, init_params(tcfg, 0, device="cpu")


def _serve(params, cfg, policy, paged):
    eng = TorchEngine(params, cfg, policy, gen_len=GEN, recompute_ratio=0.1,
                      keep_logits=True, paged_decode=paged)
    return eng, eng.serve(torch_trace("generative_agents", N_AGENTS, 2,
                                      cfg.vocab_size, seed=11,
                                      jitter_hist=False))


@pytest.mark.parametrize("policy", ["tokendance", "pic"])
def test_engine_bitexact_paged_vs_dense(qwen, policy):
    """The port's two decode loops give the same bits: outputs, first
    logits and persistent bytes (the contract of
    tests/test_paged_decode.py, inside the port)."""
    tcfg, params = qwen
    pe, p = _serve(params, tcfg, policy, True)
    de, d = _serve(params, tcfg, policy, False)
    assert pe.policy.name == de.policy.name == policy
    for r in range(2):
        np.testing.assert_array_equal(p[r].outputs, d[r].outputs)
        np.testing.assert_array_equal(p[r].first_logits, d[r].first_logits)
        assert p[r].persistent_bytes == d[r].persistent_bytes, (policy, r)
        assert p[r].reuse == d[r].reuse, (policy, r)


def test_serial_pic_matches_jax_pic(qwen):
    """The port's ``pic`` (the serial CacheBlend baseline) against the
    JAX engine's on the same weights."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = qwen[0]
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jeng = ServingEngine(params, cfg, "pic", gen_len=GEN, recompute_ratio=0.1,
                         keep_logits=True)
    js = jeng.serve(generate_trace("generative_agents", N_AGENTS, 2,
                                   cfg.vocab_size, seed=11,
                                   jitter_hist=False))
    teng, ts = _serve(tparams, tcfg, "pic", True)
    for r in range(2):
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=ATOL, rtol=0)
        assert ts[r].reuse == js[r].reuse, r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r
    assert teng.collector.align_passes == jeng.collector.align_passes


def test_policy_registry():
    assert get_policy("recompute").name == "recompute"
    assert get_policy("pic").name == "pic"
    assert get_policy("tokendance").collective
    assert not get_policy("pic").collective
    # the prefix baseline is registered too
    assert get_policy("prefix").name == "prefix"
    with pytest.raises(KeyError):
        get_policy("vllm")


def test_dense_round_kv_slices_equal_the_paged_view():
    rng = np.random.default_rng(0)
    L, N, nbt, bt, KV, hd = 2, 3, 4, 8, 2, 16
    pool = torch.from_numpy(rng.normal(size=(L, N * nbt + 2, bt, KV, hd))
                            .astype(np.float32))
    pidx = torch.from_numpy(rng.permutation(N * nbt + 2)[: N * nbt]
                            .reshape(N, nbt).astype(np.int32))
    paged = round_kv({"pk": pool, "pv": pool + 1.0, "page_idx": pidx})
    assert isinstance(paged, PagedRoundKV)
    k, v = paged.slice(0, nbt * bt)
    dense = round_kv({"k": k, "v": v, "length": None})
    assert isinstance(dense, DenseRoundKV) and dense.total == paged.total
    for lo, hi in [(0, nbt * bt), (bt, 3 * bt), (5, 19)]:
        for a, b in zip(paged.slice(lo, hi), dense.slice(lo, hi)):
            assert torch.equal(a, b)
    a, _ = dense.slice(0, bt)
    a.add_(1.0)                               # a copy, not a view
    assert torch.equal(dense.slice(0, bt)[0], paged.slice(0, bt)[0])
    assert round_kv({"ssm": None}) is None


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2.5-7b"])
def test_quickstart_runs_on_the_cpu(arch):
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--arch",
         arch, "--device", "cpu", "--batch", "2", "--prompt-len", "40",
         "--gen", "4"], env=env, cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [line for line in out.stdout.splitlines() if "req" in line]
    assert len(rows) == 2 and all(
        len(ast.literal_eval(r.split(": ", 1)[1])) == 4 for r in rows)
