"""Head dims 80, 96 and 112 through the whole port, on the CPU.

The attention backward kernel (``csrc/prefill_bwd.cuh``) takes every
head dim the forward takes, and every attention and RoPE kernel takes
head dim 112 (MPT-30B: d_model 7168 over 64 heads): ``ops.HEAD_DIMS`` is
the one tuple their wrappers check. On the CPU every wrapper runs its
plain version; held here against the JAX package, whose TPU kernels run
as its own tests run them (interpret mode):

* the plain backward (``ref.flash_attention_bwd_ref``) against
  ``jax.vjp`` of JAX's ``gqa_attention`` at head dims 80, 96 and 112:
  causal, a binding window, ragged ``kv_len`` and a soft cap of 5, at G 1
  and 4 (JAX's tolerance, atol 1e-5 + rtol 1e-4);
* the loss and every gradient leaf of one training step against
  ``jax.value_and_grad`` of JAX's ``loss_fn`` at the smoke ``qwen3-4b``
  config with its heads replaced: Phi-2's layout (4 over 4 at hd 80),
  Phi-3-mini's (4 over 4 at hd 96) and 4 over 1 at hd 112 (G 4); the
  loss to rtol 1e-5, each leaf to atol 1e-5 * its largest |g| + rtol
  1e-4 (``tests/test_torch_training.py``'s tolerance);
* the plain serving kernels against the Pallas kernels at head dim 112:
  the prefill pair, the decode pair (G 8 and 12) and ``rope_align`` (7
  and 14 16-byte words a half head in bf16 and f32), with
  ``tests/test_torch_heads.py``'s cases and tolerances;
* the port's engine against JAX's at the smoke ``qwen2.5-7b`` config with
  8 query heads over 1 KV head at head dim 112, in f32, 3 agents, 2
  rounds of ``generative_agents``, seed 11: greedy tokens equal in every
  round, first-token logits within atol 2e-4 (XLA and torch sum the same
  f32 products in another order), reuse and pool ledgers equal;
* every attention and RoPE wrapper, and the backward's, reads
  ``ops.HEAD_DIMS`` and no other tuple.

The kernels themselves are held against these plain versions on a card
(the ``gpu`` cases of ``tests/test_torch_kernels.py`` and
``tests/test_torch_decode.py``, ``chip_smoke.py``'s ``[heads]``, ``[train
heads]``, ``[train heads parity]`` and ``[serve 112]``).
"""
import json
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
from repro.models import init_params as jax_init
from repro.training.train_loop import loss_fn as jax_loss_fn
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace
from repro_torch.kernels import ops
from repro_torch.models import from_jax
from repro_torch.serving import ServingEngine
from repro_torch.training.train_loop import value_and_grad
from test_torch_heads import (
    JAX_ENGINE, _plain, test_plain_decode_matches_pallas_kernel as
    _decode_vs_pallas, test_plain_paged_decode_matches_pallas_kernel as
    _paged_decode_vs_pallas, test_plain_prefill_pair_matches_pallas_kernels
    as _prefill_pair_vs_pallas, test_plain_rope_align_matches_pallas_kernel
    as _rope_vs_pallas)
from test_torch_qwen import _random_norms
from test_torch_training import (
    BWD_CASES, _batch, _pairs, test_flash_attention_bwd_ref_matches_jax_vjp
    as _bwd_vs_jax_vjp)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 2e-4
N_AGENTS, N_ROUNDS, SEED = 3, 2, 11
# the smoke qwen2.5-7b config at 8 query heads over 1, head dim 112
SERVE_HEADS = dict(n_heads=8, n_kv_heads=1, head_dim=112)
# the smoke qwen3-4b config with Phi-2's and Phi-3-mini's head layouts (one
# KV head a query head) and head dim 112 at G 4
TRAIN_HEADS = {"hd80": dict(n_heads=4, n_kv_heads=4, head_dim=80),
               "hd96": dict(n_heads=4, n_kv_heads=4, head_dim=96),
               "hd112": dict(n_heads=4, n_kv_heads=1, head_dim=112)}


@pytest.fixture(scope="module", autouse=True)
def jax_engine(tmp_path_factory):
    """JAX's engine at the hd-112 config, started before the module's
    first test in a subprocess with one XLA thread (its jit compiles
    dominate); yields (process, output path prefix)."""
    prefix = str(tmp_path_factory.mktemp("jax_hd112") / "engine")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_ENGINE, str(N_AGENTS), str(N_ROUNDS),
         str(SEED), json.dumps(SERVE_HEADS), prefix],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, prefix
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ------------------------------------------------- the backward vs JAX
@pytest.mark.parametrize("hd", [80, 96, 112])
def test_plain_backward_matches_jax_vjp(hd):
    """``tests/test_torch_training.py``'s case (B 2, S 50, 2 KV heads) at
    each of the new head dims, for every ``BWD_CASES`` entry at G 1 and
    4."""
    for G in (1, 4):
        for case in BWD_CASES:
            _bwd_vs_jax_vjp(case, G, hd)


@pytest.mark.parametrize("layout", list(TRAIN_HEADS))
def test_loss_and_grads_match_jax_at_new_head_dims(layout):
    """One step's loss and gradients at the smoke ``qwen3-4b`` (``qk_norm``
    over the new head dims) with its heads replaced, from JAX's
    ``init_params`` (norms drawn at random) through ``from_jax``; every
    layer's attention ran its forward twice (remat) and its backward once
    through the plain versions."""
    heads = TRAIN_HEADS[layout]
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", **heads)
    tcfg = torch_smoke("qwen3-4b").replace(dtype="float32", **heads)
    assert tcfg.resolved_head_dim == heads["head_dim"]
    params = _random_norms(jax_init(jax.random.PRNGKey(0), cfg), seed=1)
    tparams = from_jax(params, tcfg, device="cpu")
    params = jax.tree.map(jnp.asarray, params)
    toks, mask = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, jnp.asarray(toks), jnp.asarray(mask),
                              remat=False), has_aux=True)(params)
    ops.reset_launches()
    tl, _, tg = value_and_grad(tparams, tcfg, torch.tensor(toks),
                               torch.tensor(mask))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert ops.PLAIN_CALLS["flash_prefill"] == 2 * tcfg.n_layers
    assert ops.PLAIN_CALLS["flash_prefill_bwd"] == tcfg.n_layers
    for path, t, j in _pairs(tg, jg):
        assert t.shape == j.shape, path
        np.testing.assert_allclose(t.numpy(), j,
                                   atol=1e-5 * float(np.abs(j).max()),
                                   rtol=1e-4, err_msg=str(path))
    for w in ("wq", "wk", "wv", "q_norm", "k_norm"):
        assert float(tg["blocks"]["attn"][w].abs().max()) > 0, w


# --------------------------------- the serving kernels at 112 vs Pallas
def test_plain_prefill_pair_matches_pallas_at_hd112():
    _prefill_pair_vs_pallas(112)


def test_plain_decode_pair_matches_pallas_at_hd112():
    """The dense decode at G 8 over 1 KV head (the engine's layout below)
    and G 12 over 2, windows 0 and 17; the paged one over pages of 16 and
    32 with a tail."""
    for G, KV in ((8, 1), (12, 2)):
        for window in (0, 17):
            _decode_vs_pallas(G, KV, 112, window)
        for bt, nbh, T, window in ((16, 6, 7, 0), (32, 3, 5, 17)):
            _paged_decode_vs_pallas(G, KV, 112, bt, nbh, T, window)


def test_plain_rope_align_matches_pallas_at_hd112():
    _rope_vs_pallas(112)


# ---------------------------------------------------- the engine vs JAX
@pytest.fixture(scope="module")
def served(jax_engine):
    """Both engines at the hd-112 config with their defaults (TokenDance,
    paged decode, incremental restore): (JAX's rounds, the port's
    plain-version calls, the port's rounds), the port's weights JAX's
    ``init_params`` from key 0 through ``from_jax``."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32",
                                                 **SERVE_HEADS)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32", **SERVE_HEADS)
    assert tcfg.resolved_head_dim == 112
    tparams = from_jax(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), cfg)), tcfg, device="cpu")
    engine = ServingEngine(tparams, tcfg, keep_logits=True)
    ops.reset_launches()
    ts = engine.serve(generate_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                     tcfg.vocab_size, seed=SEED,
                                     jitter_hist=False))
    calls = dict(ops.PLAIN_CALLS)
    proc, prefix = jax_engine
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"JAX engine failed:\n{stderr[-3000:]}"
    arrays = np.load(prefix + ".npz")
    with open(prefix + ".json") as f:
        ledgers = json.load(f)
    js = [dict(outputs=arrays["outputs"][r],
               first_logits=arrays["first_logits"][r], **ledgers[r])
          for r in range(len(ledgers))]
    return js, calls, ts


def test_engine_tokens_equal_jax_at_hd112(served):
    js, calls, ts = served
    assert calls["flash_decode_paged"] > 0 and calls["flash_decode"] == 0
    assert calls["flash_prefill"] > 0 and calls["rope_align"] > 0
    assert calls["block_diff"] > 0
    assert len(js) == len(ts) == N_ROUNDS
    for j, t in zip(js, ts):
        assert t.prompt_len == j["prompt_len"]
        np.testing.assert_array_equal(t.outputs, j["outputs"])


def test_engine_first_token_logits_close_to_jax_at_hd112(served):
    js, _, ts = served
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.first_logits, j["first_logits"],
                                   atol=LOGIT_ATOL, rtol=0)


def test_engine_reuse_and_pool_ledgers_equal_jax_at_hd112(served):
    js, _, ts = served
    for r, (j, t) in enumerate(zip(js, ts)):
        assert _plain(t.reuse) == j["reuse"], r
        assert t.persistent_bytes == j["persistent_bytes"], r
        assert t.transient_peak_bytes == j["transient_peak_bytes"], r
    assert ts[-1].reuse.get("restore"), "round 1 restored nothing"


# ------------------------------------------------- the one head-dim tuple
def test_every_attention_wrapper_reads_head_dims(monkeypatch):
    """Each attention and RoPE wrapper and the backward's, driven past its
    CPU branch with the launch recorded instead of made: every head dim
    of ``ops.HEAD_DIMS`` reaches the launch and hd 72 raises; with the
    tuple replaced by (72,), hd 72 reaches it and 112 raises. No other
    head-dim tuple is left in ``ops``."""
    assert 112 in ops.HEAD_DIMS and 80 in ops.HEAD_DIMS
    assert not [n for n in vars(ops) if n.endswith("HEAD_DIMS")
                and n != "HEAD_DIMS"]
    launched = []
    monkeypatch.setattr(ops, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, *a, **kw: launched.append(name))
    i32 = torch.int32

    def calls(hd):
        q4, kv = torch.zeros(1, 16, 4, hd), torch.zeros(1, 16, 2, hd)
        pos = torch.arange(16, dtype=i32)[None]
        pool = torch.zeros(3, 8, 2, hd)
        pidx = torch.tensor([[0, 2]], dtype=i32)
        q3 = torch.zeros(1, 4, hd)
        return {
            "rope_align": lambda: ops.rope_align(
                kv, torch.zeros(16, dtype=i32), 1e4),
            "flash_prefill": lambda: ops.flash_attention(
                q4, kv, kv, q_pos=pos, window=16),
            "flash_prefill_bwd": lambda: ops.flash_attention_bwd(
                q4, kv, kv, q4, q4, q_pos=pos, window=16),
            "flash_prefill_paged": lambda: ops.flash_prefill_paged(
                q4, pool, pool, pidx, span_len=16),
            "flash_decode_paged": lambda: ops.flash_decode_paged(
                q3, pool, pool, pidx, torch.tensor([16], dtype=i32)),
            "flash_decode": lambda: ops.flash_decode(
                q3, kv, kv, torch.tensor([16], dtype=i32), 16)}

    for hd in ops.HEAD_DIMS:
        launched.clear()
        for fn in calls(hd).values():
            fn()
        assert launched == list(calls(hd)), hd
    for name, fn in calls(72).items():
        with pytest.raises(ValueError):
            fn()
    monkeypatch.setattr(ops, "HEAD_DIMS", (72,))
    launched.clear()
    for fn in calls(72).values():
        fn()
    assert launched == list(calls(72))
    for name, fn in calls(112).items():
        with pytest.raises(ValueError):
            fn()
