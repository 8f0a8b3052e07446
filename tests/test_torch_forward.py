"""The port's ``forward`` against JAX's on the same weights (``from_jax``)
and tokens, for every ported config at its f32 smoke size, plus the
port-internal oracles the JAX model tests pin with ``forward``: decode
and extend match it, a ``long_context`` window restricts attention, and
its logits equal ``prefill``'s bit for bit. The norm scales are drawn at
random (JAX initialises them to zero), so a norm applied at the wrong
site or with the wrong leaf shows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import (decode_step, decode_step_paged, extend,
                                forward, from_jax, prefill)

torch.set_num_threads(1)

ARCHS = ["qwen2.5-7b", "qwen2.5-14b", "qwen2-72b", "qwen3-4b", "hymba-1.5b"]
B, S = 2, 24


def _random_norms(params, seed):
    """Every norm scale of the JAX pytree (``ln1``, ``q_norm``, ...) drawn
    from N(0, 0.1) instead of zeros, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if "norm" in name or name in ("ln1", "ln2"):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(params)


def _weights(arch, **replace):
    cfg = get_smoke_config(arch).replace(dtype="float32", **replace)
    tcfg = torch_smoke(arch).replace(dtype="float32", **replace)
    params = _random_norms(jax_init(jax.random.PRNGKey(0), cfg), seed=1)
    tparams = from_jax(params, tcfg, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, tparams


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _weights(request.param)


def test_forward_logits_match_jax(model):
    cfg, params, tcfg, tparams = model
    toks = _tokens(cfg)
    jl, jaux = jax_forward(params, cfg, jnp.asarray(toks))
    tl, taux = forward(tparams, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert taux.shape == () and taux.dtype == torch.float32
    assert float(taux) == float(jaux) == 0.0


def test_forward_bit_equal_to_prefill(model):
    """``forward`` and ``prefill(max_len=S)`` run the same layer loop: the
    same logits to the last bit."""
    _, _, tcfg, tparams = model
    toks = torch.from_numpy(_tokens(tcfg, seed=2))
    fl, _ = forward(tparams, tcfg, toks)
    pl, _ = prefill(tparams, tcfg, toks, max_len=S)
    assert torch.equal(fl, pl)


def test_return_hidden_matches_jax(model):
    cfg, params, tcfg, tparams = model
    toks = _tokens(cfg, seed=3)
    jh, _ = jax_forward(params, cfg, jnp.asarray(toks), return_hidden=True)
    th, taux = forward(tparams, tcfg, torch.from_numpy(toks),
                       return_hidden=True)
    assert th.shape == (B, S, cfg.d_model) and float(taux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    # the hidden state is the one the logits are read from
    from repro_torch.models.transformer import logits_of
    assert torch.equal(logits_of(tparams, tcfg, th),
                       forward(tparams, tcfg, torch.from_numpy(toks))[0])


def test_frontend_embeds_match_jax():
    cfg, params, tcfg, tparams = _weights("qwen2.5-14b")
    toks = _tokens(cfg, seed=4)
    emb = np.random.default_rng(5).standard_normal(
        (B, 6, cfg.d_model)).astype(np.float32)
    jl, _ = jax_forward(params, cfg, jnp.asarray(toks),
                        frontend_embeds=jnp.asarray(emb))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(toks),
                    frontend_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    # the embeddings replace the first six positions and nothing else
    plain, _ = forward(tparams, tcfg, torch.from_numpy(toks))
    assert not torch.allclose(tl[:, 0], plain[:, 0])
    tp, _ = prefill(tparams, tcfg, torch.from_numpy(toks),
                    frontend_embeds=torch.from_numpy(emb))
    assert torch.equal(tp, tl)


# ---------------------------------------------- port-internal oracles
@pytest.mark.parametrize("arch", ["qwen2-72b", "hymba-1.5b", "qwen3-4b",
                                  "qwen2.5-14b"])
def test_decode_matches_forward(arch):
    """Incremental decode over a dense cache equals the full-sequence
    forward (JAX's ``test_decode_matches_forward``, its tolerance)."""
    _, _, tcfg, tparams = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, seed=1, shape=(2, 16)))
    full, _ = forward(tparams, tcfg, toks)
    _, cache = prefill(tparams, tcfg, toks[:, :12], max_len=20)
    for t in range(12, 16):
        lg, cache = decode_step(tparams, tcfg, toks[:, t], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-72b"])
def test_paged_decode_matches_forward(arch):
    """The same over pages of 8 rows, the page table reversed."""
    _, _, tcfg, tparams = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, seed=1, shape=(2, 16)))
    full, _ = forward(tparams, tcfg, toks)
    _, c = prefill(tparams, tcfg, toks[:, :8], max_len=24)
    L, _, _, KV, hd = c["k"].shape
    bt, nbt = 8, 3
    pk = c["k"].reshape(L, 2 * nbt, bt, KV, hd).flip(1).contiguous()
    pv = c["v"].reshape(L, 2 * nbt, bt, KV, hd).flip(1).contiguous()
    page_idx = (2 * nbt - 1 - torch.arange(2 * nbt, dtype=torch.int32)
                ).reshape(2, nbt)
    cache = {"pk": pk, "pv": pv, "page_idx": page_idx,
             "length": c["length"]}
    for t in range(8, 16):
        lg, cache = decode_step_paged(tparams, tcfg, toks[:, t], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-5,
                                   rtol=1e-4)


def test_extend_matches_forward():
    _, _, tcfg, tparams = _weights("qwen2.5-7b")
    toks = torch.from_numpy(_tokens(tcfg, seed=1, shape=(2, 32)))
    full, _ = forward(tparams, tcfg, toks)
    _, cache = prefill(tparams, tcfg, toks[:, :20], max_len=40)
    lg, cache = extend(tparams, tcfg, toks[:, 20:], cache)
    np.testing.assert_allclose(lg.numpy(), full[:, 20:].numpy(), atol=3e-5,
                               rtol=1e-4)
    assert int(cache["length"][0]) == 32


def test_long_context_window_restricts_attention():
    """qwen3's ``long_context_window`` (4 here, one layer) with
    ``long_context=True``: a token four or more positions before the last
    does not reach the last position's logits, one inside the window
    does; JAX gives the same logits."""
    cfg, params, tcfg, tparams = _weights("qwen3-4b", n_layers=1,
                                          long_context_window=4)
    base = _tokens(tcfg, seed=1, shape=(1, 16))
    out1, _ = forward(tparams, tcfg, torch.from_numpy(base),
                      long_context=True)
    jl, _ = jax_forward(params, cfg, jnp.asarray(base), long_context=True)
    np.testing.assert_allclose(out1.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    far, near = base.copy(), base.copy()
    far[0, 3] = (far[0, 3] + 1) % tcfg.vocab_size
    near[0, 14] = (near[0, 14] + 1) % tcfg.vocab_size
    out2, _ = forward(tparams, tcfg, torch.from_numpy(far),
                      long_context=True)
    np.testing.assert_allclose(out1[0, -1].numpy(), out2[0, -1].numpy(),
                               atol=1e-6)
    out3, _ = forward(tparams, tcfg, torch.from_numpy(near),
                      long_context=True)
    assert float((out1[0, -1] - out3[0, -1]).abs().max()) > 1e-6
    # without the flag every layer attends over the whole sequence
    out4, _ = forward(tparams, tcfg, torch.from_numpy(far))
    assert float((out1[0, -1] - out4[0, -1]).abs().max()) > 1e-6


def test_long_context_reaches_decode_and_extend():
    """The window binds in the dense decode, ``extend`` and the paged
    decode too, as at the JAX entry points (the paged decode, whose
    kernel had no window, used to refuse a binding one)."""
    cfg, params, tcfg, tparams = _weights("qwen3-4b", long_context_window=4)
    toks = torch.from_numpy(_tokens(tcfg, seed=6, shape=(2, 16)))
    full, _ = forward(tparams, tcfg, toks, long_context=True)
    _, cache = prefill(tparams, tcfg, toks[:, :10], max_len=16,
                       long_context=True)
    lg, cache = extend(tparams, tcfg, toks[:, 10:12], cache,
                       long_context=True)
    np.testing.assert_allclose(lg.numpy(), full[:, 10:12].numpy(),
                               atol=3e-5, rtol=1e-4)
    for t in range(12, 16):
        lg, cache = decode_step(tparams, tcfg, toks[:, t], cache,
                                long_context=True)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-5,
                                   rtol=1e-4)
    _, c = prefill(tparams, tcfg, toks[:, :8], max_len=16, long_context=True)
    L, _, _, KV, hd = c["k"].shape
    paged = {"pk": c["k"].reshape(L, 8, 4, KV, hd),
             "pv": c["v"].reshape(L, 8, 4, KV, hd),
             "page_idx": torch.arange(8, dtype=torch.int32).reshape(2, 4),
             "length": c["length"]}
    for t in range(8, 12):
        lg, paged = decode_step_paged(tparams, tcfg, toks[:, t], paged,
                                      long_context=True)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-5,
                                   rtol=1e-4)
