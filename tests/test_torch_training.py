"""The port's ``training/`` against the JAX package's, on numpy inputs from
a seed: the schedule, clipping and AdamW; the synthetic batches; the
attention backward (the closed-form plain version against ``jax.vjp`` of
``gqa_attention``, and ``ops.flash_attention``'s autograd function
against autograd through the plain forward); ``loss_fn`` and its gradient
leaf by leaf at six f32 smoke configs; rematerialisation; five ``train``
steps; checkpoints in both directions.

Tolerances start from JAX's own (atol 1e-5, rtol 1e-4 in
``tests/test_models.py``) and are stated where they are used. Every
difference is one of summation order: XLA and torch sum the same f32
products in other orders, and torch's ``pow``/``cos`` may round the last
bit otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.models.layers import gqa_attention
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.train_loop import loss_fn as jax_loss_fn
from repro_torch import training as ttraining
from repro_torch.kernels import ops, ref
from repro_torch.models import forward
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import value_and_grad
from test_torch_qwen import _weights

torch.set_num_threads(1)

ARCHS = ["qwen2.5-7b", "qwen3-4b", "gemma3-1b", "hymba-1.5b", "grok-1-314b",
         "mamba2-2.7b"]


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _pairs(t_tree, j_tree):
    """(path, port leaf, JAX leaf) in tree order."""
    jl = dict(zip([p for p, _ in topt.tree_leaves(t_tree)],
                  jax.tree.leaves(j_tree)))
    return [(p, t, np.asarray(jl[p])) for p, t in topt.tree_leaves(t_tree)]


SHAPES = {"b": {"w": (3, 5, 7), "n": (7,)}, "a": (11,)}


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=7),
    dict(lr=2e-2, warmup_steps=5, total_steps=5)])
def test_lr_at_matches_jax(cfg):
    """The schedule in f32: the same formula (rtol 1e-6, a last-bit
    difference of f32 cos)."""
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for s in [0, 1, 3, 5, 7, 10, 11, 50, 99, 100, 150]:
        want = float(jopt.lr_at(jc, jnp.asarray(s)))
        got = float(topt.lr_at(tc, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The global norm and the clipped leaves (rtol 1e-6: the norm's sum
    of squares runs in another order)."""
    g = _tree(np.random.default_rng(0), SHAPES)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = topt.clip_by_global_norm(_torch_tree(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for p, t, j in _pairs(tg, jg):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-7,
                                   err_msg=str(p))


def test_adamw_update_matches_jax():
    """Four steps of AdamW on the same parameters and gradients, with
    warmup, decay and clipping binding: parameters and both moments
    (rtol 1e-5, atol 1e-7: the clip scale and the bias corrections round
    their last bit otherwise; the update itself is the same formula)."""
    rng = np.random.default_rng(1)
    p = _tree(rng, SHAPES)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
               grad_clip=5.0)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, p)
    tp = _torch_tree(p)
    js, ts = jopt.init_adamw(jp), topt.init_adamw(tp)
    for step in range(4):
        g = _tree(rng, SHAPES)
        jp, js, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g),
                                       js)
        tp, ts, tm = topt.adamw_update(tc, tp, _torch_tree(g), ts)
        assert int(ts.step) == int(js.step) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for a, b in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for path, t, j in _pairs(a, b):
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                           atol=1e-7, err_msg=str(path))


def test_adamw_updates_a_stacked_leaf_in_slices():
    """A leaf larger than one slice (``PART``) is updated slice by slice:
    the same values as one whole-leaf update (the clip does not bind: the
    norm's sum of squares runs per slice, in another order)."""
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((6, 4, 5)).astype(np.float32)}
    g = {"w": rng.standard_normal((6, 4, 5)).astype(np.float32)}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0, grad_clip=1e6)
    whole, _, _ = topt.adamw_update(cfg, _torch_tree(p), _torch_tree(g),
                                    topt.init_adamw(_torch_tree(p)))
    old = topt.PART
    topt.PART = 40                          # two layers a slice
    try:
        assert len(list(topt.parts(torch.zeros(6, 4, 5)))) == 3
        sliced, _, _ = topt.adamw_update(cfg, _torch_tree(p), _torch_tree(g),
                                         topt.init_adamw(_torch_tree(p)))
    finally:
        topt.PART = old
    assert torch.equal(whole["w"], sliced["w"])


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("seed,vocab,S,B", [
    (0, 512, 48, 8), (5, 151936, 64, 2), (11, 97, 9, 3)])
def test_synthetic_tokens_bit_equal_to_jax(seed, vocab, S, B):
    kw = dict(vocab_size=vocab, seq_len=S, global_batch=B, seed=seed)
    jd = jtraining.SyntheticTokens(jtraining.DataConfig(**kw))
    td = ttraining.SyntheticTokens(ttraining.DataConfig(**kw))
    for i in (0, 1, 7):
        for a, b in zip(td.batch(i), jd.batch(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- attention backward
def _attn_inputs(seed, B, S, H, KV, hd, qs=1.0):
    rng = np.random.default_rng(seed)
    q = (qs * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


# (window, kv_len, softcap): causal; a binding window; ragged kv_len with
# a window (every row keeps an allowed column: kv_len >= S - window + 1);
# a soft cap of 5 with q scaled so the cap bends the logits
BWD_CASES = {"causal": (None, None, 0.0), "window": (9, None, 0.0),
             "kv_len": (40, [50, 23], 0.0), "softcap": (None, None, 5.0)}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("hd", [32, 64])
def test_flash_attention_bwd_ref_matches_jax_vjp(case, G, hd):
    """The closed-form backward against ``jax.vjp`` of
    ``gqa_attention`` (JAX's tolerance, atol 1e-5 + rtol 1e-4)."""
    window, kv_len, cap = BWD_CASES[case]
    B, S, KV = 2, 50, 2
    H = KV * G
    q, k, v, do = _attn_inputs(hd + G, B, S, H, KV, hd, 3.0 if cap else 1.0)
    w = window or S
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    valid = None
    if kv_len is not None:
        valid = jnp.asarray(np.arange(S)[None] < np.asarray(kv_len)[:, None])

    def f(q, k, v):
        return gqa_attention(q, k, v, q_pos=jnp.asarray(pos),
                             kv_pos=jnp.asarray(pos), window=w, softcap=cap,
                             kv_valid=valid)

    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = ref.flash_attention_bwd_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(np.asarray(jout)), torch.tensor(do),
        q_pos=torch.tensor(np.ascontiguousarray(pos)), window=w, kv_len=kl,
        softcap=cap)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_autograd_function_matches_autograd_through_the_plain_forward(case):
    """``ops.flash_attention`` with grad: the plain forward then the plain
    backward on the CPU (one count each), the same wiring as the kernels
    on the card; its gradients equal autograd through
    ``flash_attention_ref`` (atol 1e-5 + rtol 1e-4: the closed form sums
    in another order than autograd's chain)."""
    window, kv_len, cap = BWD_CASES[case]
    B, S, KV, G, hd = 2, 50, 2, 3, 32
    arrs = _attn_inputs(7, B, S, KV * G, KV, hd, 3.0 if cap else 1.0)
    q, k, v = (torch.tensor(a).requires_grad_() for a in arrs[:3])
    do = torch.tensor(arrs[3])
    kw = dict(q_pos=torch.arange(S, dtype=torch.int32).expand(B, S)
              .contiguous(), window=window or S, softcap=cap,
              kv_len=None if kv_len is None
              else torch.tensor(kv_len, dtype=torch.int32))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), do)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    assert ops.PLAIN_CALLS["flash_prefill"] == 1
    assert ops.PLAIN_CALLS["flash_prefill_bwd"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_attention_builds_no_graph_unless_asked():
    """Without grad (serving) the call is the forward alone: no autograd
    node, no backward counted; under ``no_grad`` neither, even for inputs
    that require grad."""
    q, k, v, _ = (torch.tensor(a) for a in _attn_inputs(3, 1, 20, 4, 2, 32))
    kw = dict(q_pos=torch.arange(20, dtype=torch.int32)[None], window=20)
    ops.reset_launches()
    assert ops.flash_attention(q, k, v, **kw).grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v, **kw)
    assert out.grad_fn is None and ops.PLAIN_CALLS["flash_prefill"] == 2
    assert ops.PLAIN_CALLS["flash_prefill_bwd"] == 0


# ----------------------------------------------------------- the loss
def _batch(cfg, S=48, B=2, seed=3):
    toks, mask = jtraining.SyntheticTokens(jtraining.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=seed)).batch(0)
    mask = mask.copy()
    mask[0, -5:] = 0.0                      # a partial mask
    return toks, mask


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, chunk):
    """``loss_fn`` and its gradient, leaf by leaf, against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` (``remat=False``), with
    and without the chunked xent (chunks of 16 over S 47: a padded last
    chunk). Gemma3's window (64 in the smoke config) binds at S 96. The
    loss to rtol 1e-5; each gradient leaf to atol 1e-5 * (its largest
    |g|) + rtol 1e-4 — JAX's tolerance, the absolute part scaled to the
    leaf, as gradient leaves range over four orders of magnitude."""
    cfg, params, tcfg, tparams = _weights(arch)
    cfg = cfg.replace(xent_chunk=chunk)
    tcfg = tcfg.replace(xent_chunk=chunk)
    toks, mask = _batch(cfg, S=96 if arch == "gemma3-1b" else 48)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, jnp.asarray(toks), jnp.asarray(mask),
                              remat=False), has_aux=True)(params)
    ops.reset_launches()
    tl, tparts, tg = value_and_grad(tparams, tcfg, torch.tensor(toks),
                                    torch.tensor(mask))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tparts["xent"]) == pytest.approx(float(jparts["xent"]),
                                                  rel=1e-5)
    assert float(tparts["aux"]) == pytest.approx(float(jparts["aux"]),
                                                 rel=1e-5, abs=1e-7)
    n_attn = tcfg.n_layers if tcfg.has_attention else 0
    # remat: every layer's forward twice, its backward once
    assert ops.PLAIN_CALLS["flash_prefill"] == 2 * n_attn
    assert ops.PLAIN_CALLS["flash_prefill_bwd"] == n_attn
    for path, t, j in _pairs(tg, jg):
        assert t.shape == j.shape and t.dtype == torch.float32, path
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * scale,
                                   rtol=1e-4, err_msg=str(path))
    if tcfg.has_attention:
        for w in ("wq", "wk", "wv"):
            assert float(tg["blocks"]["attn"][w].abs().max()) > 0, w


@pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b", "hymba-1.5b"])
def test_remat_is_bit_equal(arch):
    """``forward(remat=True)`` recomputes each layer in the backward: the
    same loss and gradients, bit for bit (one thread: torch's CPU
    embedding backward sums in a thread-dependent order)."""
    _, _, tcfg, tparams = _weights(arch)
    toks, mask = (torch.tensor(a) for a in _batch(tcfg))
    a = value_and_grad(tparams, tcfg, toks, mask, remat=True)
    b = value_and_grad(tparams, tcfg, toks, mask, remat=False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(topt.tree_leaves(a[2]), topt.tree_leaves(b[2])))


def test_forward_without_grad_keeps_the_serving_path():
    """Parameters that require no grad: ``forward`` builds no graph and
    runs no backward, whatever ``remat`` says."""
    _, _, tcfg, tparams = _weights("qwen3-4b")
    toks = torch.tensor(_batch(tcfg)[0])
    ops.reset_launches()
    a, _ = forward(tparams, tcfg, toks)
    b, _ = forward(tparams, tcfg, toks, remat=True)
    assert a.grad_fn is None and b.grad_fn is None and torch.equal(a, b)
    assert ops.PLAIN_CALLS["flash_prefill_bwd"] == 0


# ---------------------------------------------------------- the loop
def test_train_matches_jax_five_steps():
    """Five steps of ``train`` from the same weights and batches: the
    losses step by step (rtol 1e-4: AdamW divides each gradient by its own
    root mean square, which turns last-bit gradient differences into
    larger ones in the smallest gradients)."""
    cfg, params, tcfg, tparams = _weights("qwen3-4b")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    dc = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=2)
    jres = jtraining.train(cfg, jtraining.AdamWConfig(**opt),
                           iter(jtraining.SyntheticTokens(
                               jtraining.DataConfig(**dc))), 5,
                           params=params, log_every=0)
    tres = ttraining.train(tcfg, ttraining.AdamWConfig(**opt),
                           iter(ttraining.SyntheticTokens(
                               ttraining.DataConfig(**dc))), 5,
                           params=tparams, log_every=0, device="cpu")
    assert tres.steps == jres.steps == 5
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert int(tres.opt_state.step) == 5


def test_loss_decreases_dense():
    """The port alone, as ``tests/test_training.py`` trains JAX's: 40
    steps on the synthetic pipeline lower the loss by 0.3."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    dc = ttraining.DataConfig(vocab_size=cfg.vocab_size, seq_len=48,
                              global_batch=8)
    res = ttraining.train(cfg, ttraining.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=40),
        iter(ttraining.SyntheticTokens(dc)), 40, log_every=0, device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.3


# ------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(tmp_path):
    _, _, tcfg, tparams = _weights("gemma3-1b")
    path = str(tmp_path / "ck")
    tckpt.save(path, tparams, {"arch": tcfg.name})
    back = tckpt.load(path, tparams)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(topt.tree_leaves(tparams), topt.tree_leaves(back)))
    bf = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    tckpt.save(str(tmp_path / "bf"), bf)
    assert torch.equal(tckpt.load(str(tmp_path / "bf"), bf)["w"], bf["w"])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX-written checkpoint (parameters, and an AdamW state after one
    step) loads into the port's trees, and the port's into JAX's: the
    same leaves in the same order, bit for bit."""
    cfg, params, tcfg, tparams = _weights("hymba-1.5b")
    jckpt.save(str(tmp_path / "j"), params)
    got = tckpt.load(str(tmp_path / "j"), tparams)
    for path, t, j in _pairs(got, params):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    tckpt.save(str(tmp_path / "t"), tparams)
    back = jckpt.load(str(tmp_path / "t"), params)
    for path, t, j in _pairs(tparams, back):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    # an optimizer state: (step, m, v) in field order in both
    grads = jax.tree.map(lambda x: jnp.full(x.shape, 0.5, x.dtype), params)
    _, jstate, _ = jopt.adamw_update(jopt.AdamWConfig(), params, grads,
                                     jopt.init_adamw(params))
    jckpt.save(str(tmp_path / "s"), jstate)
    tstate = tckpt.load(str(tmp_path / "s"), topt.init_adamw(tparams))
    assert isinstance(tstate, topt.AdamWState) and int(tstate.step) == 1
    for path, t, j in _pairs(tstate.m, jstate.m):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
