"""The last five model families in the port against the JAX package, on
their f32 smoke configs: ``grok-1-314b`` (MoE, logit soft cap 30),
``arctic-480b`` (128-expert MoE cut to 4, dense residual),
``mamba2-2.7b`` (attention-free SSD), ``musicgen-large`` (audio frontend,
KV = H) and ``chameleon-34b`` (vision frontend, ``qk_norm``). Every entry
point JAX has for the family — ``forward`` and ``prefill`` (with
``frontend_embeds`` where a frontend is set), ``decode_step``, and for
the attention models ``decode_step_paged`` and ``extend`` (the PIC
selective block with MoE is in ``test_torch_moe.py``; the serving engine
in ``test_torch_archs_engines.py``). The norm scales are drawn at random
(JAX initialises them to zero), as in ``test_torch_qwen.py``.

Tolerances: logits atol 3e-5 + rtol 1e-4 (JAX's own for decode against
forward, ``tests/test_models.py``); the MoE load-balance loss to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import prefill as jax_prefill
from repro.models.transformer import extend as jax_extend
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import decode_step, extend, forward, prefill
from test_torch_gemma import _paged_decode_both
from test_torch_qwen import _weights

torch.set_num_threads(1)

NEW = ["grok-1-314b", "arctic-480b", "mamba2-2.7b", "musicgen-large",
       "chameleon-34b"]
ATTENTION = [a for a in NEW if a != "mamba2-2.7b"]
B, S, GEN, SF = 2, 96, 8, 16
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module", params=NEW)
def model(request):
    return _weights(request.param)


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, shape).astype(np.int32)


def _embeds(cfg, seed):
    """Seeded frontend embeddings ``[B, SF, D]`` for a model with a
    frontend (the stubbed audio / vision encoder's output), else None."""
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, SF, cfg.d_model)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_registry_equals_jax():
    """Every architecture of the JAX package, in its order."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert set(NEW) <= set(tconfigs.list_archs())


def test_the_families_have_their_features(model):
    _, _, tcfg, tparams = model
    blocks = tparams["blocks"]
    assert ("moe" in blocks) == tcfg.is_moe
    assert ("attn" in blocks) == tcfg.has_attention
    assert ("mlp" in blocks) == (tcfg.arch_type not in ("moe", "ssm"))
    if tcfg.name.startswith("grok"):
        assert tcfg.attn_logit_softcap == 30.0
        assert tcfg.capacity_factor == 4.0        # dropless in the smoke
    if tcfg.name.startswith("arctic"):
        assert "dense" in blocks["moe"]
    if tcfg.name.startswith("musicgen"):
        assert tcfg.n_heads == tcfg.n_kv_heads and tcfg.frontend == "audio"
    if tcfg.name.startswith("chameleon"):
        assert tcfg.qk_norm and tcfg.frontend == "vision"


# ------------------------------------------------------- entry points
def test_forward_matches_jax(model):
    """Logits and the MoE load-balance loss (summed over layers; zero
    without MoE), with frontend embeddings replacing the first positions
    where the model has a frontend."""
    cfg, params, tcfg, tparams = model
    toks, emb = _tokens(cfg, 0), _embeds(cfg, 1)
    jl, jaux = jax_forward(params, cfg, jnp.asarray(toks),
                           frontend_embeds=None if emb is None
                           else jnp.asarray(emb))
    tl, taux = forward(tparams, tcfg, torch.from_numpy(toks),
                       frontend_embeds=None if emb is None
                       else torch.from_numpy(emb))
    _close(tl, jl)
    assert taux.shape == () and taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= 1e-6, (float(taux), float(jaux))
    assert (float(taux) > 0) == tcfg.is_moe
    if emb is not None:
        plain, _ = forward(tparams, tcfg, torch.from_numpy(toks))
        assert not torch.allclose(plain, tl, atol=1e-3), "embeds ignored"


def test_prefill_and_decode_step_match_jax(model):
    """``prefill`` (with frontend embeddings where set) and 8 greedy
    ``decode_step``s on its cache: attention K/V or the SSM and conv
    states, and the logits of every step."""
    cfg, params, tcfg, tparams = model
    toks, emb = _tokens(cfg, 2), _embeds(cfg, 3)
    jl, jc = jax_prefill(params, cfg, jnp.asarray(toks), max_len=S + GEN,
                         frontend_embeds=None if emb is None
                         else jnp.asarray(emb))
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=S + GEN,
                     frontend_embeds=None if emb is None
                     else torch.from_numpy(emb))
    _close(tl, jl)
    for key in ("k", "v", "ssm", "conv"):
        assert (key in tc) == (key in jc), key
        if key in tc:
            _close(tc[key], jc[key])
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    ops.reset_launches()
    for _ in range(GEN):
        jlg, jc = jax_decode(params, cfg, jnp.asarray(tok), jc)
        tlg, tc = decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        _close(tlg, jlg)
        tok = np.asarray(jlg.argmax(-1)).astype(np.int32)
    calls = ops.PLAIN_CALLS["flash_decode"]
    assert calls == (GEN * tcfg.n_layers if tcfg.has_attention else 0)


@pytest.mark.parametrize("arch", ATTENTION)
def test_decode_step_paged_matches_jax(arch):
    """Paged decode over the prefill's pages and one generation page:
    the capped attention (Grok), MoE routing of one token a sequence,
    G 1 (MusicGen) and ``qk_norm`` (Chameleon)."""
    _paged_decode_both(*_weights(arch), seed=4, steps=GEN)


@pytest.mark.parametrize("arch", ATTENTION)
def test_extend_matches_jax(arch):
    """A cache of 40 prompt tokens extended by 56 in one pass (the prefix
    policy's suffix compute)."""
    cfg, params, tcfg, tparams = _weights(arch)
    toks = _tokens(cfg, 5)
    _, jc = jax_prefill(params, cfg, jnp.asarray(toks[:, :40]), max_len=S)
    _, tc = prefill(tparams, tcfg, torch.from_numpy(toks[:, :40]), max_len=S)
    jl, jc = jax_extend(params, cfg, jnp.asarray(toks[:, 40:]), jc)
    tl, tc = extend(tparams, tcfg, torch.from_numpy(toks[:, 40:]), tc)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
