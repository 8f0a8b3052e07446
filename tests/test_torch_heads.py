"""Head layouts past the first four on the port, on the CPU.

The decode pair (``csrc/decode_attn.cuh``) takes any number G of query
heads a KV head: a block serves its G heads in chunks of 8, each head's
recurrence, splits and merge unchanged, so the chunks change no order of
any sum (no emulation of the chunked merge is needed beside the plain
version). The serving kernels take head dims 80 (Phi-2) and 96 (Phi-3,
GPT-NeoX-20B) as well as 32, 64, 128 and 256. On the CPU every wrapper
runs its plain version; held here against the JAX package, whose TPU
kernels run as its own tests run them (interpret mode):

* the plain ``flash_decode`` and ``flash_decode_paged`` against JAX's
  ``flash_decode_kernel`` and ``flash_decode_paged_kernel`` at G 12, 16
  and 29 (Mistral-Large-2, Llama-3.1-405B, Falcon-180B) and head dims 80
  and 96, Sk about 100, windows 0 and 17, pages of 16 and 32: f32, atol
  1e-5 (the same products summed in another order);
* the plain prefill pair against ``flash_prefill_kernel`` and
  ``flash_prefill_paged_kernel`` at head dims 80 and 96 (atol 1e-5);
* the plain ``rope_align`` against ``rope_align_kernel`` at head dims 80
  and 96 (atol 3e-4: the Pallas kernel's frequencies are exp(-x ln θ),
  f32 ulps of the angle at |delta| up to 1000, as in
  ``tests/test_torch_kernels.py``);
* the port's engine against JAX's at the smoke ``qwen2.5-7b`` config with
  16 query heads over 1 KV head at head dim 96 (G 16), in f32, 3 agents,
  2 rounds of ``generative_agents``, seed 11: greedy tokens equal,
  first-token logits within atol 2e-4 (XLA and torch sum the same f32
  products in another order), reuse and pool ledgers equal.

The kernels themselves are held against these plain versions on a card
(``tests/test_torch_kernels.py``'s and ``tests/test_torch_decode.py``'s
``gpu`` cases, ``chip_smoke.py``'s ``[heads]`` and ``[heads serve]``).
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
from repro.kernels import ops as jops
from repro.kernels.rope_align import rope_align_kernel
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace
from repro_torch.kernels import ops
from repro_torch.models import from_jax
from repro_torch.serving import ServingEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL = 1e-5          # f32 sums in another order
LOGIT_ATOL = 2e-4
N_AGENTS, N_ROUNDS, SEED = 3, 2, 11
# the smoke qwen2.5-7b config at G 16, head dim 96
HEADS = dict(n_heads=16, n_kv_heads=1, head_dim=96)

# The JAX engine at the wide-head config: its rounds' tokens and
# first-token logits into an npz, its ledgers into a json. Its jit
# compiles dominate this file, so it runs in a subprocess that an autouse
# module fixture starts before the first test, beside the port's work.
JAX_ENGINE = r"""
import json, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params
from repro.serving import ServingEngine

n, rounds, seed, heads, out = sys.argv[1:]
cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32",
                                             **json.loads(heads))
eng = ServingEngine(init_params(jax.random.PRNGKey(0), cfg), cfg,
                    keep_logits=True)
stats = eng.serve(generate_trace("generative_agents", int(n), int(rounds),
                                 cfg.vocab_size, seed=int(seed),
                                 jitter_hist=False))

def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return np.asarray(x).tolist()

np.savez(out + ".npz", outputs=np.stack([s.outputs for s in stats]),
         first_logits=np.stack([s.first_logits for s in stats]))
with open(out + ".json", "w") as f:
    json.dump([dict(reuse=plain({k: v for k, v in s.reuse.items()
                                 if k != "plan"}),
                    persistent_bytes=int(s.persistent_bytes),
                    transient_peak_bytes=int(s.transient_peak_bytes),
                    prompt_len=int(s.prompt_len)) for s in stats], f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_engine(tmp_path_factory):
    """Start the JAX engine before the module's first test; yields
    (process, output path prefix). Killed at teardown if still running.
    One thread for XLA's CPU pool, so the subprocess does not take every
    core from the test workers."""
    prefix = str(tmp_path_factory.mktemp("jax_heads") / "engine")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_ENGINE, str(N_AGENTS), str(N_ROUNDS),
         str(SEED), json.dumps(HEADS), prefix],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, prefix
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------- the decode pair vs Pallas
# (G, KV, hd): Mistral-Large-2's G 12 and Llama-3.1-405B's 16 over 2 KV
# heads, Falcon-180B's 29 over 1, each at head dims 80 and 96
WIDE = [(G, KV, hd) for G, KV in ((12, 2), (16, 2), (29, 1))
        for hd in (80, 96)]


@pytest.mark.parametrize("window", [0, 17])
@pytest.mark.parametrize("G,KV,hd", WIDE)
def test_plain_decode_matches_pallas_kernel(G, KV, hd, window):
    """One sequence at position Sk - 1 = 100 over a dense cache; window
    17 binds (its first allowed row is 84)."""
    r = np.random.default_rng(G * hd + window)
    H, Sk = G * KV, 101
    q = r.standard_normal((H, hd)).astype(np.float32)
    k, v = (r.standard_normal((KV, Sk, hd)).astype(np.float32)
            for _ in range(2))
    want = jops.flash_decode(jnp.asarray(q[:, None]), jnp.asarray(k),
                             jnp.asarray(v), window=window)
    got = ops.flash_decode(_t(q[None]), _t(k.transpose(1, 0, 2)[None]),
                           _t(v.transpose(1, 0, 2)[None]),
                           torch.tensor([Sk], dtype=torch.int32),
                           window or Sk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[:, 0],
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("bt,nbh,T,window", [(16, 6, 7, 0), (32, 3, 5, 17)])
@pytest.mark.parametrize("G,KV,hd", WIDE)
def test_plain_paged_decode_matches_pallas_kernel(G, KV, hd, bt, nbh, T,
                                                   window):
    """One sequence over ``nbh`` whole pages of ``bt`` rows from a
    shuffled pool, then a tail of T rows (about 100 positions); window 0
    (none) and 17, whose first allowed row lies in the last page."""
    r = np.random.default_rng(G * hd + bt)
    H, P = G * KV, nbh + 3
    q = r.standard_normal((H, hd)).astype(np.float32)
    pk, pv = (r.standard_normal((P, bt, KV, hd)).astype(np.float32)
              for _ in range(2))
    tk, tv = (r.standard_normal((T, KV, hd)).astype(np.float32)
              for _ in range(2))
    pidx = r.permutation(P)[:nbh].astype(np.int32)
    span = nbh * bt
    want = jops.flash_decode_paged(
        jnp.asarray(q[:, None]), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(pidx), jnp.asarray(tk), jnp.asarray(tv), span_len=span,
        window=window)
    got = ops.flash_decode_paged(
        _t(q[None]), _t(pk), _t(pv), _t(pidx[None]),
        torch.tensor([span], dtype=torch.int32), _t(tk[None]), _t(tv[None]),
        T, window=window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[:, 0],
                               atol=F32_ATOL, rtol=0)


# --------------------------------- the prefill pair and RoPE vs Pallas
@pytest.mark.parametrize("hd", [80, 96])
def test_plain_prefill_pair_matches_pallas_kernels(hd):
    """The dense prefill (causal, S 80, and a window of 30) against
    ``flash_prefill_kernel``, and the paged prefill over 3 pages of 16
    and a tail of 9 (window 0 and 30) against
    ``flash_prefill_paged_kernel``, 8 query heads over 2."""
    r = np.random.default_rng(hd)
    H, KV, S = 8, 2, 80
    q = r.standard_normal((S, H, hd)).astype(np.float32)
    k, v = (r.standard_normal((S, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = _t(np.arange(S, dtype=np.int32)[None])
    for window in (0, 30):
        got = ops.flash_attention(_t(q[None]), _t(k[None]), _t(v[None]),
                                  q_pos=pos, window=window or S)[0]
        want = jops.flash_prefill(
            jnp.asarray(q.transpose(1, 0, 2)),
            jnp.asarray(k.transpose(1, 0, 2)),
            jnp.asarray(v.transpose(1, 0, 2)), window=window, block_q=32,
            block_k=32)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(1, 0, 2),
                                   atol=F32_ATOL, rtol=0)

    bt, nbh, T = 16, 3, 9
    P, span = nbh + 2, nbh * bt
    qp = r.standard_normal((span + T, H, hd)).astype(np.float32)
    pk, pv = (r.standard_normal((P, bt, KV, hd)).astype(np.float32)
              for _ in range(2))
    tk, tv = (r.standard_normal((T, KV, hd)).astype(np.float32)
              for _ in range(2))
    pidx = r.permutation(P)[:nbh].astype(np.int32)
    for window in (0, 30):
        got = ops.flash_prefill_paged(
            _t(qp[None]), _t(pk), _t(pv), _t(pidx[None]), _t(tk[None]),
            _t(tv[None]), span_len=span, window=window)[0]
        want = jops.flash_prefill_paged(
            jnp.asarray(qp.transpose(1, 0, 2)), jnp.asarray(pk),
            jnp.asarray(pv), jnp.asarray(pidx), jnp.asarray(tk),
            jnp.asarray(tv), span_len=span, window=window, use_kernel=True)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(1, 0, 2),
                                   atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("hd", [80, 96])
def test_plain_rope_align_matches_pallas_kernel(hd):
    """Half a head is 40 or 48 values: 5 / 10 (hd 80) and 6 / 12 (hd 96)
    16-byte words in bf16 / f32, the word counts the kernel gained."""
    r = np.random.default_rng(hd)
    S, KV = 64, 2
    k = r.standard_normal((S, KV, hd)).astype(np.float32)
    src = r.integers(0, 1000, S).astype(np.int32)
    tgt = r.integers(0, 1000, S).astype(np.int32)
    got = ops.rope_align(_t(k), _t(tgt - src), 1e6).numpy()
    want = np.asarray(rope_align_kernel(jnp.asarray(k), jnp.asarray(src),
                                        jnp.asarray(tgt), 1e6, tile_s=32,
                                        interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)


# ---------------------------------------------------- the engine vs JAX
def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return np.asarray(x).tolist()


@pytest.fixture(scope="module")
def served(jax_engine):
    """Both engines at the G 16, hd 96 config with their defaults
    (TokenDance, paged decode, incremental restore): (JAX's rounds, the
    port's plain-version calls, the port's rounds). The port's weights
    are JAX's ``init_params`` from key 0, carried over by ``from_jax``."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32", **HEADS)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32", **HEADS)
    assert tcfg.resolved_head_dim == 96 and tcfg.n_heads // \
        tcfg.n_kv_heads == 16
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


def test_engine_tokens_equal_jax_at_g16_hd96(served):
    js, calls, ts = served
    # the paged decode loop ran, and so did the recovery's prefill
    assert calls["flash_decode_paged"] > 0 and calls["flash_decode"] == 0
    assert calls["flash_prefill"] > 0 and calls["rope_align"] > 0
    assert len(js) == len(ts) == N_ROUNDS
    for j, t in zip(js, ts):
        assert t.prompt_len == j["prompt_len"]
        np.testing.assert_array_equal(t.outputs, j["outputs"])


def test_engine_first_token_logits_close_to_jax_at_g16_hd96(served):
    js, _, ts = served
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.first_logits, j["first_logits"],
                                   atol=LOGIT_ATOL, rtol=0)


def test_engine_reuse_and_pool_ledgers_equal_jax_at_g16_hd96(served):
    js, _, ts = served
    for r, (j, t) in enumerate(zip(js, ts)):
        assert _plain(t.reuse) == j["reuse"], r
        assert t.persistent_bytes == j["persistent_bytes"], r
        assert t.transient_peak_bytes == j["transient_peak_bytes"], r
    assert ts[-1].reuse.get("restore"), "round 1 restored nothing"
