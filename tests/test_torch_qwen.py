"""The Qwen family in the port against the JAX package: the configs field
by field, ``qk_norm`` at every entry point that projects q and k
(``prefill``, ``decode_step``, ``decode_step_paged``, ``extend`` and the
PIC selective block), and the default engine and the prefix policy served
on the f32 smoke configs of ``qwen3-4b`` and ``qwen2.5-14b``. The norm
scales are drawn at random (JAX initialises them to zero), so a norm
read from the wrong leaf or applied at the wrong site shows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import pic as jpic
from repro.core.rounds import generate_trace as jax_trace
from repro.models import decode_step as jax_decode
from repro.models import decode_step_paged as jax_decode_paged
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.transformer import extend as jax_extend
from repro.serving import ServingEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.core import pic as tpic
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import (decode_step, decode_step_paged, extend,
                                from_jax, init_params, prefill)
from repro_torch.serving import ServingEngine as TorchEngine

torch.set_num_threads(1)

PORTED = ["qwen2.5-7b", "qwen2.5-14b", "qwen2-72b", "qwen3-4b",
          "hymba-1.5b", "gemma3-1b", "gemma3-12b"]
B, S, BT = 2, 64, 32


def _random_norms(params, seed):
    """Every norm scale of the JAX pytree drawn from N(0, 0.1) instead of
    zeros, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if "norm" in name or name in ("ln1", "ln2"):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(params)


def _weights(arch):
    cfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    tcfg = tconfigs.get_smoke_config(arch).replace(dtype="float32")
    params = _random_norms(jax_init(jax.random.PRNGKey(0), cfg), seed=1)
    tparams = from_jax(params, tcfg, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, tparams


@pytest.fixture(scope="module")
def qwen3():
    return _weights("qwen3-4b")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_jax_field_by_field(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    assert dataclasses.asdict(tconfigs.get_smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.get_smoke_config(arch))
    assert tconfigs.get_config(arch).param_count() == \
        jconfigs.get_config(arch).param_count()


def test_registry_and_input_shapes_equal_jax():
    assert set(tconfigs.list_archs()) == set(PORTED)
    assert set(tconfigs.list_archs()) <= set(jconfigs.list_archs())
    assert {k: dataclasses.asdict(v)
            for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert isinstance(tconfigs.INPUT_SHAPES["long_500k"],
                      tconfigs.InputShape)


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_has_the_jax_leaves(arch):
    """The port's random weights have JAX's pytree: the same leaves, each
    of the same shape and dtype (``q_norm``/``k_norm`` zeros ``[L, hd]``
    where the config has ``qk_norm``)."""
    for dt in ("float32", "bfloat16"):
        cfg = jconfigs.get_smoke_config(arch).replace(dtype=dt)
        tcfg = tconfigs.get_smoke_config(arch).replace(dtype=dt)
        want = _flat(jax.tree.map(
            lambda x: (tuple(x.shape), str(x.dtype)),
            jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), cfg))))
        got = _flat(init_params(tcfg, 0, device="cpu"))
        assert sorted(got) == sorted(want), arch
        for path, t in got.items():
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
                want[path], path
        if tcfg.qk_norm:
            for leaf in ("q_norm", "k_norm"):
                t = got[("blocks", "attn", leaf)]
                assert t.shape == (tcfg.n_layers, tcfg.resolved_head_dim)
                assert not t.any()


def _check_from_jax(cfg, params, tcfg, tparams):
    """Every leaf of JAX's pytree, and no other: the ``q_norm``/``k_norm``
    leaves as they were, and no ``lm_head`` where the embeddings are
    tied."""
    assert cfg.qk_norm and tcfg.qk_norm
    assert sorted(_flat(tparams)) == sorted(_flat(params))
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    for leaf in ("q_norm", "k_norm"):
        np.testing.assert_array_equal(
            tparams["blocks"]["attn"][leaf].numpy(),
            np.asarray(params["blocks"]["attn"][leaf]))
        assert tparams["blocks"]["attn"][leaf].abs().sum() > 0


def test_from_jax_keeps_the_qk_norm_leaves(qwen3):
    _check_from_jax(*qwen3)


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-12b"])
def test_from_jax_carries_the_tied_pytree(arch):
    _check_from_jax(*_weights(arch))


# ------------------------------------------------- qk_norm, entry points
def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, shape).astype(np.int32)


def test_qk_norm_prefill_and_dense_decode_match_jax(qwen3):
    cfg, params, tcfg, tparams = qwen3
    toks = _tokens(cfg, 0)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(toks), max_len=S + 8)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=S + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    # keys are cached after the norm and after RoPE
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=0)
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    for _ in range(8):
        jlg, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlg, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jlg.argmax(-1)).astype(np.int32)


def test_qk_norm_paged_decode_matches_jax(qwen3):
    cfg, params, tcfg, tparams = qwen3
    toks = _tokens(cfg, 1)
    G = 8
    jl, jcache = jax_prefill(params, cfg, jnp.asarray(toks))
    nb_s, nb_g = S // BT, 1
    nbt = nb_s + nb_g

    def to_pool(x):
        L, _, _, KV, hd = x.shape
        x = x.reshape(L, B, nb_s, BT, KV, hd)
        x = np.pad(x, ((0, 0), (0, 0), (0, nb_g), (0, 0), (0, 0), (0, 0)))
        return x.reshape(L, B * nbt, BT, KV, hd)

    pk, pv = to_pool(np.asarray(jcache["k"])), to_pool(np.asarray(jcache["v"]))
    page_idx = np.arange(B * nbt, dtype=np.int32).reshape(B, nbt)
    jc = {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv),
          "page_idx": jnp.asarray(page_idx),
          "kv_pos": jnp.pad(jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32),
                                             (B, S)), ((0, 0), (0, nb_g * BT))),
          "kv_valid": jnp.pad(jnp.ones((B, S), bool), ((0, 0), (0, nb_g * BT))),
          "length": jnp.full((B,), S, jnp.int32)}
    tc = {"pk": torch.from_numpy(pk.copy()), "pv": torch.from_numpy(pv.copy()),
          "page_idx": torch.from_numpy(page_idx),
          "length": torch.full((B,), S, dtype=torch.int32)}
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    for _ in range(G):
        jlg, jc = jax_decode_paged(params, cfg, jnp.asarray(tok), jc)
        tlg, tc = decode_step_paged(tparams, tcfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jlg.argmax(-1)).astype(np.int32)


def test_qk_norm_extend_matches_jax(qwen3):
    cfg, params, tcfg, tparams = qwen3
    toks = _tokens(cfg, 2)
    _, jc = jax_prefill(params, cfg, jnp.asarray(toks[:, :40]), max_len=S)
    _, tc = prefill(tparams, tcfg, torch.from_numpy(toks[:, :40]), max_len=S)
    jl, jc = jax_extend(params, cfg, jnp.asarray(toks[:, 40:]), jc)
    tl, tc = extend(tparams, tcfg, torch.from_numpy(toks[:, 40:]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-14b"])
def test_pic_selective_block_matches_jax(arch):
    """Collective recovery with private histories: ``check_layer`` 0, so
    every later layer is a selective block (q/k normed there with
    ``qk_norm``)."""
    cfg, params, tcfg, tparams = _weights(arch)
    r = np.random.default_rng(5)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    f = lambda *s: (0.3 * r.normal(size=s)).astype(np.float32)  # noqa: E731
    toks = _tokens(cfg, 3, (3, 128))
    shared_k, shared_v = np.zeros((2, L, 128, KV, hd), np.float32)
    shared_src = np.arange(128, dtype=np.int32)
    shared_mask = np.zeros(128, bool)
    shared_k[:, 64:96], shared_v[:, 64:96] = f(L, 32, KV, hd), \
        f(L, 32, KV, hd)
    shared_src[64:96] = np.arange(300, 332)
    shared_mask[64:96] = True
    priv_k, priv_v = f(3, L, 128, KV, hd), f(3, L, 128, KV, hd)
    priv_src = np.tile(np.arange(128, dtype=np.int32), (3, 1))
    priv_src[:, :32] += 5
    priv_mask = np.zeros(128, bool)
    priv_mask[:32] = True
    fresh = ~(shared_mask | priv_mask)
    n_sel = tpic.n_sel_for_blocks(fresh, BT, 0.3)
    args = (toks, shared_k, shared_v, shared_src, shared_mask)
    kw = dict(priv_k=priv_k, priv_v=priv_v, priv_src=priv_src,
              priv_mask=priv_mask)
    jr = jpic.pic_prefill(params, cfg, *map(jnp.asarray, args), n_sel,
                          check_layer=0, block_select=BT,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tpic.pic_prefill(tparams, tcfg, *map(torch.from_numpy, args), n_sel,
                          check_layer=0, block_select=BT,
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tr.sel_idx.numpy(), np.asarray(jr.sel_idx))
    for f_ in ("recovered_k", "recovered_v", "logits", "hidden_sel"):
        np.testing.assert_allclose(getattr(tr, f_).numpy(),
                                   np.asarray(getattr(jr, f_)), atol=1e-4,
                                   rtol=0, err_msg=f_)


# ---------------------------------------------------------------- engines
KW = dict(gen_len=32, recompute_ratio=0.1, keep_logits=True)
TRACE = dict(seed=11, jitter_hist=False)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return np.asarray(x).tolist()


def _serve_both(arch, policy, n_rounds, workload="generative_agents"):
    cfg, params, tcfg, tparams = _weights(arch)
    pol = () if policy is None else (policy,)
    jeng = JaxEngine(params, cfg, *pol, **KW)
    js = jeng.serve(jax_trace(workload, 3, n_rounds, cfg.vocab_size, **TRACE))
    teng = TorchEngine(tparams, tcfg, *pol, **KW)
    ts = teng.serve(torch_trace(workload, 3, n_rounds, tcfg.vocab_size,
                                **TRACE))
    return jeng, js, teng, ts


def _assert_served_alike(jeng, js, teng, ts):
    """Greedy tokens equal per agent per round, first-token logits within
    2e-4 (XLA and torch sum the same f32 products in another order), and
    the reuse / pool ledgers and byte counts equal."""
    assert len(ts) == len(js)
    for r, (t, j) in enumerate(zip(ts, js)):
        np.testing.assert_array_equal(t.outputs, j.outputs)
        np.testing.assert_allclose(t.first_logits, j.first_logits,
                                   atol=2e-4, rtol=0)
        want = {k: v for k, v in j.reuse.items() if k != "plan"}
        assert _plain(t.reuse) == _plain(want), r
        assert t.persistent_bytes == j.persistent_bytes, r
        assert t.transient_peak_bytes == j.transient_peak_bytes, r
        assert t.prompt_len == j.prompt_len and t.mode == j.mode, r
    assert teng._persistent_bytes() == jeng._persistent_bytes()


@pytest.mark.parametrize("arch,n_rounds", [("qwen3-4b", 3),
                                           ("qwen2.5-14b", 3)])
def test_default_engine_matches_jax(arch, n_rounds):
    jeng, js, teng, ts = _serve_both(arch, None, n_rounds)
    assert teng.policy.name == "tokendance" and teng.policy.incremental
    _assert_served_alike(jeng, js, teng, ts)
    # round 2 restores only the round delta, in both packages
    assert ts[-1].reuse["restore"]["incremental"]


def test_prefix_policy_with_qk_norm_matches_jax():
    """The prefix baseline's ``extend`` on qwen3: the suffix's q and k
    normed before RoPE, over the cached (normed) prefix."""
    jeng, js, teng, ts = _serve_both("qwen3-4b", "prefix", 3,
                                     workload="agent_society")
    _assert_served_alike(jeng, js, teng, ts)
    assert all(s.reuse.get("prefix_len", 0) > 0 for s in ts[1:])
