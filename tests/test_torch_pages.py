"""Page sizes other than 32 in the port, on the CPU.

The port's paged decode kernel (``csrc/flash_decode_paged.cu``) takes any
page size: its 32-row tiles cover positions, and the row at position c
reads slot ``c % bt`` of page ``page_idx[c // bt]`` (c < span) or tail
row ``c - span``. The two restore kernels take any (bt, hd) with ``hd %
16 == 0``. Held here:

* the plain ``flash_decode_paged`` (the CPU path of the wrapper) against
  JAX's ``flash_decode_paged_kernel`` in interpret mode, at pages of 16
  and 64 (a span of whole pages, a tail, no window and a binding one);
* the kernel's tiling, written out in plain torch (each tile's rows and
  masks, the splits and their merge), against the plain version at pages
  of 16, 24, 32, 64 and 128, and the host's split count against it;
* the plain restores against JAX's two restore kernels (interpret mode)
  at bt 64, hd 256 in f32: 2048 (token, 16-byte chunk) pairs a tile, and
  the storage walkthrough at blocks of 64;
* the port's engine against JAX's at ``block_select`` 16 (gen 32) and 64
  (gen 64): smoke ``qwen2.5-7b`` in f32, ``generative_agents``, 3 agents,
  3 rounds, seed 11, ``recompute_ratio`` 0.1, the default incremental
  restore: tokens equal in every round, first-token logits within atol
  2e-4 (XLA and torch sum the same f32 products in another order), reuse
  and pool ledgers equal.

The kernels themselves are held against these plain versions on a card
(``tests/test_torch_kernels.py``'s ``gpu`` cases, ``chip_smoke.py``'s
``[pages]`` phase).
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
from repro.kernels import ref as jref
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace
from repro_torch.kernels import ops, ref
from repro_torch.models import from_jax
from repro_torch.serving import ServingEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_AGENTS, N_ROUNDS, SEED = 3, 3, 11
F32_ATOL = 2e-5          # f32 sums in another order
LOGIT_ATOL = 2e-4
THETA = 1e4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------- paged decode vs Pallas
@pytest.mark.parametrize("bt,nbh,T", [(16, 5, 21), (64, 2, 40)])
@pytest.mark.parametrize("window", [0, 50])
def test_plain_paged_decode_matches_pallas_kernel(bt, nbh, T, window):
    """One sequence over ``nbh`` whole pages of ``bt`` rows from a
    shuffled pool, then a tail of T rows: window 0 (none) and 50, which
    binds (the first allowed row lies in the pages)."""
    r = np.random.default_rng(bt + window)
    H, KV, hd, P = 4, 2, 32, nbh + 3
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


# ---------------------------------------- the kernel's tiling, in torch
def _position_tiles(q, pk, pv, pidx, span, tk, tv, tail_len, window):
    """``flash_decode_paged_kernel``'s walk in plain torch, sequence by
    sequence: tile t holds positions t*32 .. t*32+31 (``PagedRows``: a
    position below the span from its page and slot, then the tail, then
    zeros), the pair visits tiles [t_begin, t_end), split s walks
    ``DECODE_SPLIT_TILES`` of them from t_begin + s * T and keeps (m, l,
    acc) of its masked scores, and the splits merge in order. Returns the
    output and the most splits any pair needed."""
    B, H, hd = q.shape
    _, bt, KV, _ = pk.shape
    nbt = pidx.shape[1]
    Tp = tk.shape[1] if tk is not None else 0
    T = ops.DECODE_SPLIT_TILES
    G, scale = H // KV, 1.0 / np.sqrt(hd)
    win = window or 2 ** 31 - 1
    out = torch.zeros(B, KV, G, hd)
    most = 1
    for b in range(B):
        sp = max(min(int(span[b]), nbt * bt), 0)
        qpos = sp + (min(tail_len, Tp) if tk is not None else 0) - 1
        t_end = (qpos + 32) // 32
        t_begin = min(max(qpos - win + 1, 0) // 32, t_end)
        R = t_end * 32
        k, v = torch.zeros(R, KV, hd), torch.zeros(R, KV, hd)
        for c in range(R):
            if c < sp:
                page = int(pidx[b, c // bt])
                k[c], v[c] = pk[page, c % bt], pv[page, c % bt]
            elif c - sp < Tp:
                k[c], v[c] = tk[b, c - sp], tv[b, c - sp]
        pos = torch.arange(R)
        allowed = (pos <= qpos) & (qpos - pos < win)
        parts = []
        for t0 in range(t_begin, t_end, T):
            rows = slice(t0 * 32, min(t0 + T, t_end) * 32)
            qg = q[b].reshape(KV, G, hd)
            sc = torch.einsum("kgd,jkd->kgj", qg, k[rows]) * scale
            sc = torch.where(allowed[rows], sc, torch.tensor(-2.0 ** 30))
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgj,jkd->kgd", p,
                                                     v[rows])))
        most = max(most, len(parts))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        w = [torch.exp(m - M) for m, _, _ in parts]
        lsum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[b] = num / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, H, hd), most


@pytest.mark.parametrize("bt", [16, 24, 32, 64, 128])
def test_position_tiles_equal_paged_plain_version(bt):
    """Spans ragged and whole (1, 33, 5 pages, every page), with and
    without a tail of 37 rows (given with tail_len 0 too), windows of
    none, 40 and 100: the tiling gives the plain version's function, and
    the host's split count (the wrapper's ``_split_operands`` plan) is
    enough for every pair."""
    r = np.random.default_rng(bt)
    B, H, KV, hd, nbt, Tp = 4, 4, 2, 32, max(256 // bt, 2), 48
    P = B * nbt + 3
    q = _t(r.standard_normal((B, H, hd)).astype(np.float32))
    pk, pv = (_t(r.standard_normal((P, bt, KV, hd)).astype(np.float32))
              for _ in range(2))
    tk, tv = (_t(r.standard_normal((B, Tp, KV, hd)).astype(np.float32))
              for _ in range(2))
    pidx = _t(r.permutation(P)[: B * nbt].reshape(B, nbt).astype(np.int32))
    span = torch.tensor([1, 33, min(5, nbt) * bt, nbt * bt],
                        dtype=torch.int32)
    for tails in ((), (tk, tv, 37), (tk, tv, 0)):
        S, _ = ops.decode_split_plan(
            -(-(nbt * bt + (Tp if tails else 0)) // 32), B, KV, H // KV, hd)
        for window in (0, 40, 100):
            got, most = _position_tiles(q, pk, pv, pidx, span,
                                        *(tails or (None, None, 0)),
                                        window=window)
            assert most <= S, (bt, tails[2:], window, most, S)
            want = ref.flash_decode_paged_ref(q, pk, pv, pidx, span, *tails,
                                              window=window)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------- restores vs Pallas
@pytest.mark.parametrize("family", [False, True], ids=["mirror", "family"])
def test_plain_restores_match_pallas_kernels_at_bt64_hd256(family):
    """Pages of 64 at head dim 256 in f32 (Gemma3's head dim, its f32
    recovery at block 64): 64 x 128 / 4 = 2048 (token, 16-byte chunk)
    pairs a tile, more than one 1024-thread block of the restore kernel
    holds. Half the blocks keep a zero delta
    (identity: exact), the rest rotate by deltas below 64; V never rotates
    (exact). Rotated K: within f32 atol 1e-5 of JAX's reference (torch and
    XLA each compute the angles' cos and sin), and within 4e-5 of the
    Pallas kernel, whose frequencies exp(-x ln theta) differ from the
    reference's by f32 ulps (delta < 64 times 2^-23 is ~7.5e-6 of an
    angle, times |k| < 5)."""
    r = np.random.default_rng(64 + family)
    L, nb, bt, KV, hd, ndb = 1, 3, 64, 1, 256, 2
    M = 2 if family else 1
    mk, mv = (r.standard_normal((L, nb, bt, KV, hd)).astype(np.float32)
              for _ in range(2))
    dk, dv = (r.standard_normal((M, L, ndb, bt, KV, hd)).astype(np.float32)
              for _ in range(2))
    slot = np.full((M, nb), -1, np.int32)
    for m in range(M):
        slot[m, r.choice(nb, ndb, replace=False)] = np.arange(ndb)
    P = M * nb + 2
    pages = r.permutation(P)[: M * nb].reshape(M, nb).astype(np.int32)
    delta = r.integers(0, 64, (M, nb, bt)).astype(np.int32)
    delta[:, ::2] = 0
    pool = (L, P, bt, KV, hd)
    zeros = [torch.zeros(pool), torch.zeros(pool)]
    J = jnp.asarray
    if family:
        got = ops.fused_family_restore(_t(mk), _t(mv), _t(dk), _t(dv), slot,
                                       pages, delta, THETA, *zeros)
        jargs = (J(mk), J(mv), J(dk), J(dv), J(slot), J(pages), J(delta),
                 THETA, jnp.zeros(pool), jnp.zeros(pool))
        kernel = jops.fused_family_restore(*jargs)
        plain = jref.fused_family_restore_ref(*jargs)
    else:
        got = ops.fused_diff_restore(_t(mk), _t(mv), _t(dk[0]), _t(dv[0]),
                                     slot[0], pages[0], delta[0], THETA,
                                     *zeros)
        jargs = (J(mk), J(mv), J(dk[0]), J(dv[0]), J(slot[0]), J(pages[0]),
                 J(delta[0]), THETA, jnp.zeros(pool), jnp.zeros(pool))
        kernel = jops.fused_diff_restore(*jargs)
        plain = jref.fused_diff_restore_ref(*jargs)
    gk, gv = (x.numpy() for x in got)
    still = pages[(delta == 0).all(axis=-1)]
    for want, atol in ((kernel, 4e-5), (plain, 1e-5)):
        wk, wv = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gk[:, still], wk[:, still])
        np.testing.assert_allclose(gk, wk, atol=atol, rtol=0)
    assert np.abs(gk).sum() > 0


def test_walkthrough_at_block_64():
    """The storage walkthrough (``examples.compression_demo``) at
    ``block_select=64`` selects whole 64-token blocks and builds its
    family in 64-token blocks, so its restores run at pages of 64 (the
    walkthrough asserts the three restore paths bit-equal and every
    mirror's pages equal to its recovered KV)."""
    from repro_torch.configs import get_smoke_config as smoke
    from repro_torch.examples.compression_demo import (group_tokens,
                                                       walkthrough)
    from repro_torch.models import init_params

    cfg = smoke("qwen2.5-7b").replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    tokens = group_tokens(cfg.vocab_size, 4, priv_len=64, block_len=128,
                          seed=1)
    ops.reset_launches()
    wt = walkthrough(params, cfg, tokens, 64, ratio=0.05, block_select=64,
                     log=lambda *a: None)
    assert wt.group.n_sel % 64 == 0 and wt.group.n_sel > 0
    assert len(wt.handles) == 3
    assert {h.diff.block_tokens for h in wt.handles} == {64}
    assert wt.slot_maps.shape == (3, (64 + 4 * 128) // 64)
    assert ops.PLAIN_CALLS["fused_family_restore"] == 1
    assert ops.PLAIN_CALLS["fused_diff_restore"] == 3


# -------------------------------------------------- the engine vs JAX
ENGINE_CASES = {"pages16": (16, 32), "pages64": (64, 64)}

# The JAX engine at one (block_select, gen_len), as the tests below need
# it: its rounds' tokens and first-token logits into an npz, its ledgers
# into a json. Its jit compiles (~17 s a case on the CPU) dominate this
# file, so both cases run in subprocesses of their own, started together
# before the first test of the module, beside the port's work here.
JAX_ENGINE = r"""
import json, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params
from repro.serving import ServingEngine

bs, gen, n, rounds, seed, out = sys.argv[1:]
cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
eng = ServingEngine(init_params(jax.random.PRNGKey(0), cfg), cfg,
                    block_select=int(bs), gen_len=int(gen),
                    recompute_ratio=0.1, keep_logits=True)
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
def jax_engines(tmp_path_factory):
    """Start the JAX engine of every case; yields case -> (process, output
    path prefix). Processes still running at teardown are killed."""
    out = tmp_path_factory.mktemp("jax_engines")
    # one thread for XLA's CPU pool: the subprocesses run beside the
    # other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    runs = {}
    for case, (bs, gen) in ENGINE_CASES.items():
        prefix = str(out / case)
        runs[case] = (subprocess.Popen(
            [sys.executable, "-c", JAX_ENGINE, str(bs), str(gen),
             str(N_AGENTS), str(N_ROUNDS), str(SEED), prefix],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), prefix)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _jax_result(run):
    proc, prefix = run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"JAX engine failed:\n{stderr[-3000:]}"
    arrays = np.load(prefix + ".npz")
    with open(prefix + ".json") as f:
        ledgers = json.load(f)
    return [dict(outputs=arrays["outputs"][r],
                 first_logits=arrays["first_logits"][r], **ledgers[r])
            for r in range(len(ledgers))]


@pytest.fixture(scope="module")
def port_engines(jax_engines):
    """The port's engine of every case with its defaults (the incremental
    restore), served while JAX's run: case -> (plain calls, stats). The
    weights are JAX's ``init_params`` from key 0, carried over by
    ``from_jax``."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), cfg)), tcfg, device="cpu")
    runs = {}
    for case, (bs, gen) in ENGINE_CASES.items():
        teng = ServingEngine(tparams, tcfg, block_select=bs, gen_len=gen,
                             recompute_ratio=0.1, keep_logits=True)
        ops.reset_launches()
        ts = teng.serve(generate_trace("generative_agents", N_AGENTS,
                                       N_ROUNDS, tcfg.vocab_size, seed=SEED,
                                       jitter_hist=False))
        runs[case] = (dict(ops.PLAIN_CALLS), ts)
    return runs


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def served(request, jax_engines, port_engines):
    """Both engines at one (block_select, gen_len); the prompts are then
    multiples of the page (80 / 208 / 240 at 16, 128 / 384 / 448 at 64),
    so every decode step runs the paged loop."""
    bs, gen = ENGINE_CASES[request.param]
    calls, ts = port_engines[request.param]
    return bs, gen, _jax_result(jax_engines[request.param]), calls, ts


def test_engine_tokens_equal_jax_every_round(served):
    bs, gen, js, calls, ts = served
    # every decode step went through the paged loop (pages of bs rows)
    assert calls["flash_decode_paged"] > 0 and calls["flash_decode"] == 0
    assert len(js) == len(ts) == N_ROUNDS
    for j, t in zip(js, ts):
        assert t.prompt_len == j["prompt_len"] and t.prompt_len % bs == 0
        assert t.outputs.shape == (N_AGENTS, gen)
        np.testing.assert_array_equal(t.outputs, j["outputs"])


def test_engine_first_token_logits_close_to_jax(served):
    _, _, js, _, ts = served
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.first_logits, j["first_logits"],
                                   atol=LOGIT_ATOL, rtol=0)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return np.asarray(x).tolist()


def test_engine_reuse_and_pool_ledgers_equal_jax(served):
    bs, _, js, _, ts = served
    for r, (j, t) in enumerate(zip(js, ts)):
        assert _plain(t.reuse) == j["reuse"], (bs, r)
        assert t.persistent_bytes == j["persistent_bytes"], (bs, r)
        assert t.transient_peak_bytes == j["transient_peak_bytes"], (bs, r)
    restore = ts[-1].reuse["restore"]
    assert restore["incremental"] and restore["pool_pages"] > 0
