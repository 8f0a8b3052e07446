"""Gemma3 in the port against the JAX package, on the f32 smoke configs of
``gemma3-1b`` (4 query heads over 1 KV head) and ``gemma3-12b`` (4 over
2): tied embeddings (the logits read ``embed.T``), the 5:1 local:global
window pattern at every entry point (``prefill``, ``decode_step``,
``decode_step_paged``, ``extend``, ``forward``) with the smoke window of
64 binding, and the engine served with its defaults, the prefix policy
and the dense decode loop. ``decode_step_paged`` also runs with
``long_context=True`` on ``qwen3-4b``, whose window the paged decode
kernel now takes. The norm scales are drawn at random (JAX initialises
them to zero), as in ``test_torch_qwen.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.rounds import generate_trace as jax_trace
from repro.models import decode_step as jax_decode
from repro.models import decode_step_paged as jax_decode_paged
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.transformer import extend as jax_extend
from repro.serving import ServingEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, decode_step_paged, extend,
                                forward, from_jax, init_params, prefill)
from repro_torch.models.layers import rmsnorm
from repro_torch.serving import ServingEngine as TorchEngine
from test_torch_qwen import (KW, TRACE, _assert_served_alike, _random_norms,
                             _weights)

torch.set_num_threads(1)

GEMMA = ["gemma3-1b", "gemma3-12b"]
B, S, BT, GEN = 2, 96, 32, 32
# JAX's own tolerance for decode against forward (tests/test_models.py)
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module", params=GEMMA)
def gemma(request):
    return _weights(request.param)


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, shape).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_smoke_window_binds_on_the_local_layers(gemma):
    cfg, _, tcfg, tparams = gemma
    assert tcfg.tie_embeddings and "lm_head" not in tparams
    assert tcfg.layer_window_sizes(S + GEN) == (64, S + GEN)
    assert tcfg.resolved_head_dim == 32


# ------------------------------------------------------- entry points
def test_prefill_and_forward_match_jax(gemma):
    cfg, params, tcfg, tparams = gemma
    toks = _tokens(cfg, 0)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(toks), max_len=S + GEN)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=S + GEN)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    jf, _ = jax_forward(params, cfg, jnp.asarray(toks))
    tf, _ = forward(tparams, tcfg, torch.from_numpy(toks))
    _close(tf, jf)


def test_decode_step_matches_jax(gemma):
    cfg, params, tcfg, tparams = gemma
    toks = _tokens(cfg, 1)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(toks), max_len=S + GEN)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=S + GEN)
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    for _ in range(8):
        jlg, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlg, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        _close(tlg, jlg)
        tok = np.asarray(jlg.argmax(-1)).astype(np.int32)


def _paged_caches(jcache, n_gen_pages=1):
    """JAX's and the port's paged decode caches over a prefill cache of S
    rows: each sequence's S // BT pages, then ``n_gen_pages`` empty ones
    (the engine's layout)."""
    k, v = np.asarray(jcache["k"]), np.asarray(jcache["v"])
    L, _, _, KV, hd = k.shape
    nb_s = S // BT
    nbt = nb_s + n_gen_pages

    def to_pool(x):
        x = x[:, :, :S].reshape(L, B, nb_s, BT, KV, hd)
        x = np.pad(x, ((0, 0), (0, 0), (0, n_gen_pages), (0, 0), (0, 0),
                       (0, 0)))
        return x.reshape(L, B * nbt, BT, KV, hd)

    pk, pv = to_pool(k), to_pool(v)
    page_idx = np.arange(B * nbt, dtype=np.int32).reshape(B, nbt)
    pad = ((0, 0), (0, n_gen_pages * BT))
    jc = {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv),
          "page_idx": jnp.asarray(page_idx),
          "kv_pos": jnp.pad(jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32),
                                             (B, S)), pad),
          "kv_valid": jnp.pad(jnp.ones((B, S), bool), pad),
          "length": jnp.full((B,), S, jnp.int32)}
    tc = {"pk": torch.from_numpy(pk.copy()), "pv": torch.from_numpy(pv.copy()),
          "page_idx": torch.from_numpy(page_idx),
          "length": torch.full((B,), S, dtype=torch.int32)}
    return jc, tc


def _paged_decode_both(cfg, params, tcfg, tparams, seed, steps,
                       long_context=False):
    toks = _tokens(cfg, seed)
    jl, jcache = jax_prefill(params, cfg, jnp.asarray(toks),
                             long_context=long_context)
    jc, tc = _paged_caches(jcache)
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    ops.reset_launches()
    for _ in range(steps):
        jlg, jc = jax_decode_paged(params, cfg, jnp.asarray(tok), jc,
                                   long_context=long_context)
        tlg, tc = decode_step_paged(tparams, tcfg, torch.from_numpy(tok), tc,
                                    long_context=long_context)
        _close(tlg, jlg)
        tok = np.asarray(jlg.argmax(-1)).astype(np.int32)
    assert ops.PLAIN_CALLS["flash_decode_paged"] == steps * tcfg.n_layers


def test_decode_step_paged_with_a_binding_window_matches_jax(gemma):
    """Pages of 128 rows (3 of the prompt, 1 for generation): the local
    layers' window of 64 binds from the first step; the paged loop used
    to raise ``NotImplementedError`` here."""
    cfg, params, tcfg, tparams = gemma
    _paged_decode_both(cfg, params, tcfg, tparams, 2, steps=12)


def test_qwen3_long_context_paged_decode_matches_jax():
    """``long_context=True`` gives every layer ``long_context_window``,
    cut to 48 below the pages' 128 rows: the paged loop computes where it
    used to raise."""
    cfg, params, tcfg, tparams = _weights("qwen3-4b")
    cfg, tcfg = (c.replace(long_context_window=48) for c in (cfg, tcfg))
    _paged_decode_both(cfg, params, tcfg, tparams, 3, steps=6,
                       long_context=True)


def test_extend_matches_jax(gemma):
    cfg, params, tcfg, tparams = gemma
    toks = _tokens(cfg, 4)
    _, jc = jax_prefill(params, cfg, jnp.asarray(toks[:, :40]), max_len=S)
    _, tc = prefill(tparams, tcfg, torch.from_numpy(toks[:, :40]), max_len=S)
    jl, jc = jax_extend(params, cfg, jnp.asarray(toks[:, 40:]), jc)
    tl, tc = extend(tparams, tcfg, torch.from_numpy(toks[:, 40:]), tc)
    _close(tl, jl)
    _close(tc["k"], jc["k"])


def test_sliding_window_restricts_attention():
    """JAX's ``test_sliding_window_restricts_attention`` on the port: one
    local layer of window 4; a token 12 positions before the last leaves
    its logits exactly as they were, one inside the window moves them."""
    cfg = tconfigs.get_smoke_config("gemma3-1b").replace(
        dtype="float32", n_layers=1, sliding_window=4,
        global_layer_interval=0)
    params = init_params(cfg, 0, device="cpu")
    base = torch.from_numpy(_tokens(cfg, 5, (1, 16)).astype(np.int64))
    out1, _ = forward(params, cfg, base)
    far = base.clone()
    far[0, 3] = (far[0, 3] + 1) % cfg.vocab_size
    out2, _ = forward(params, cfg, far)
    np.testing.assert_allclose(out1[0, -1].numpy(), out2[0, -1].numpy(),
                               atol=1e-6)
    near = base.clone()
    near[0, 14] = (near[0, 14] + 1) % cfg.vocab_size
    out3, _ = forward(params, cfg, near)
    assert float((out1[0, -1] - out3[0, -1]).abs().max()) > 1e-6


def test_tied_logits_read_the_embedding():
    """The logits of a tied model are the final-normed state times
    ``embed.T``, and JAX's pytree (no ``lm_head``) loads as it is."""
    cfg = jconfigs.get_smoke_config("gemma3-1b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke_config("gemma3-1b").replace(dtype="float32")
    params = _random_norms(jax_init(jax.random.PRNGKey(3), cfg), seed=2)
    assert "lm_head" not in params
    tparams = from_jax(params, tcfg, device="cpu")
    assert sorted(tparams) == sorted(params)
    np.testing.assert_array_equal(tparams["embed"].numpy(), params["embed"])
    toks = torch.from_numpy(_tokens(cfg, 6, (1, 8)).astype(np.int64))
    hidden, _ = forward(tparams, tcfg, toks, return_hidden=True)
    logits, _ = forward(tparams, tcfg, toks)
    want = rmsnorm(hidden, tparams["final_norm"], tcfg.rmsnorm_eps) @ \
        tparams["embed"].T
    torch.testing.assert_close(logits, want, atol=0, rtol=0)


# ---------------------------------------------------------------- engines
def _serve_both(arch, workload, policy=(), **kw):
    cfg, params, tcfg, tparams = _weights(arch)
    jeng = JaxEngine(params, cfg, *policy, **KW, **kw)
    js = jeng.serve(jax_trace(workload, 3, 3, cfg.vocab_size, **TRACE))
    teng = TorchEngine(tparams, tcfg, *policy, **KW, **kw)
    ts = teng.serve(torch_trace(workload, 3, 3, tcfg.vocab_size, **TRACE))
    return jeng, js, teng, ts


@pytest.mark.parametrize("workload", ["generative_agents", "agent_society"])
@pytest.mark.parametrize("arch", GEMMA)
def test_default_engine_matches_jax(arch, workload):
    """TokenDance with paged decode and incremental restore, 3 rounds:
    G 4 over one KV head (1B) and G 2 over 2 (12B), the window binding on
    the local layers from round 0 (prompts of 96 tokens and more)."""
    jeng, js, teng, ts = _serve_both(arch, workload)
    assert teng.policy.name == "tokendance" and teng.policy.incremental
    assert teng.paged_decode
    assert min(s.prompt_len for s in ts) > 64
    _assert_served_alike(jeng, js, teng, ts)
    assert ts[-1].reuse["restore"]["incremental"]


@pytest.mark.parametrize("arch", GEMMA)
def test_prefix_policy_matches_jax(arch):
    """The prefix baseline's ``extend`` under the layers' windows."""
    jeng, js, teng, ts = _serve_both(arch, "agent_society", ("prefix",))
    _assert_served_alike(jeng, js, teng, ts)
    assert all(s.reuse.get("prefix_len", 0) > 0 for s in ts[1:])


def test_dense_decode_loop_matches_jax_and_the_paged_loop():
    """``paged_decode=False`` on gemma3-1b: the dense loop against JAX's
    dense loop, and bit-equal to the port's paged loop (the window is
    applied by both decode kernels' plain versions on the same rows)."""
    jeng, js, teng, ts = _serve_both("gemma3-1b", "generative_agents",
                                     paged_decode=False)
    _assert_served_alike(jeng, js, teng, ts)
    paged = TorchEngine(teng.params, teng.cfg, **KW).serve(torch_trace(
        "generative_agents", 3, 3, teng.cfg.vocab_size, **TRACE))
    for d, p in zip(ts, paged):
        np.testing.assert_array_equal(d.outputs, p.outputs)
        np.testing.assert_array_equal(d.first_logits, p.first_logits)
        assert d.persistent_bytes == p.persistent_bytes
