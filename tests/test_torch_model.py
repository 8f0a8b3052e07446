"""The port's model against the JAX model on the same weights (``from_jax``
on the f32 smoke config): prefill logits, eight paged decode steps, and
the paged decode's independence from where its pages live."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import decode_step_paged as jax_decode_paged
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import decode_step_paged, from_jax, prefill

torch.set_num_threads(1)

B, S, G, BT = 2, 64, 8, 32


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (B, S)).astype(np.int32)
    return cfg, params, tcfg, tparams, tokens


def test_from_jax_keeps_every_leaf(models):
    cfg, params, tcfg, tparams, _ = models
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert flat
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_prefill_logits_match_jax(models):
    cfg, params, tcfg, tparams, tokens = models
    jl, jcache = jax_prefill(params, cfg, jnp.asarray(tokens))
    tl, tcache = prefill(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4, rtol=0)
    last, _ = prefill(tparams, tcfg, torch.from_numpy(tokens),
                      logits_last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), tl[:, -1].numpy(),
                               atol=1e-5, rtol=0)


def _paged_caches(jcache, tcache, perm=None):
    """The serving engine's decode cache (prefill KV as each sequence's
    sealed pages, then zeroed gen pages) in both frameworks; ``perm``
    relocates the port's pages in its pool."""
    nb_s, nb_g = S // BT, G // BT + 1
    nbt = nb_s + nb_g

    def to_pool(x):
        L, _, _, KV, hd = x.shape
        x = x.reshape(L, B, nb_s, BT, KV, hd)
        x = np.pad(x, ((0, 0), (0, 0), (0, nb_g), (0, 0), (0, 0), (0, 0)))
        return x.reshape(L, B * nbt, BT, KV, hd)

    jk, jv = to_pool(np.asarray(jcache["k"])), to_pool(np.asarray(jcache["v"]))
    page_idx = np.arange(B * nbt, dtype=np.int32).reshape(B, nbt)
    jc = {"pk": jnp.asarray(jk), "pv": jnp.asarray(jv),
          "page_idx": jnp.asarray(page_idx),
          "kv_pos": jnp.pad(jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32),
                                             (B, S)), ((0, 0), (0, nbt * BT - S))),
          "kv_valid": jnp.pad(jnp.ones((B, S), bool),
                              ((0, 0), (0, nbt * BT - S))),
          "length": jnp.full((B,), S, jnp.int32)}
    tk, tv, tidx = np.array(jk), np.array(jv), page_idx.copy()
    if perm is not None:
        shape = (jk.shape[0], int(perm.max()) + 1) + jk.shape[2:]
        tk, tv = np.zeros(shape, jk.dtype), np.zeros(shape, jv.dtype)
        tk[:, perm], tv[:, perm] = jk, jv
        tidx = perm[page_idx].astype(np.int32)
    tc = {"pk": torch.from_numpy(tk), "pv": torch.from_numpy(tv),
          "page_idx": torch.from_numpy(tidx),
          "length": torch.full((B,), S, dtype=torch.int32)}
    return jc, tc


def _decode(step, tok, cache, n):
    logits = []
    for _ in range(n):
        lg, cache = step(tok, cache)
        logits.append(np.asarray(lg))
        tok = lg.argmax(-1)
    return np.stack(logits, 1), cache


def test_decode_step_paged_matches_jax(models):
    cfg, params, tcfg, tparams, tokens = models
    jl, jcache = jax_prefill(params, cfg, jnp.asarray(tokens))
    tl, tcache = prefill(tparams, tcfg, torch.from_numpy(tokens))
    jc, tc = _paged_caches(jcache, tcache)
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    jstep = jax.jit(lambda t, c: jax_decode_paged(params, cfg, t, c))
    jlog, _ = _decode(lambda t, c: jstep(jnp.asarray(t, jnp.int32), c),
                      tok, jc, G)
    tlog, tc_end = _decode(
        lambda t, c: decode_step_paged(tparams, tcfg,
                                       torch.as_tensor(np.asarray(t),
                                                       dtype=torch.int32), c),
        tok, tc, G)
    np.testing.assert_allclose(tlog, jlog, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tlog.argmax(-1), jlog.argmax(-1))
    assert tc_end["length"].tolist() == [S + G] * B


def test_decode_step_paged_is_page_layout_independent(models):
    """The same sequences with their pages scattered elsewhere in the pool
    decode bit for bit alike."""
    cfg, params, tcfg, tparams, tokens = models
    jl, jcache = jax_prefill(params, cfg, jnp.asarray(tokens))
    _, tcache = prefill(tparams, tcfg, torch.from_numpy(tokens))
    _, plain = _paged_caches(jcache, tcache)
    n_pages = plain["pk"].shape[1]
    perm = np.random.default_rng(1).permutation(n_pages + 5)[:n_pages]
    _, moved = _paged_caches(jcache, tcache, perm=perm)
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)

    def step(t, c):
        return decode_step_paged(tparams, tcfg, torch.as_tensor(
            np.asarray(t), dtype=torch.int32), c)

    a, _ = _decode(step, tok, plain, G)
    b, _ = _decode(step, tok, moved, G)
    np.testing.assert_array_equal(a, b)
