"""The port's core against the JAX core on the same inputs: traces and
segment hashes, Master-Mirror compression, the page-sharing family
restore, and PIC recovery (paged and dense) with its top-k tie rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import collector as jcol
from repro.core import diff_store as jds
from repro.core import pic as jpic
from repro.core import restore as jrestore
from repro.core import rounds as jrounds
from repro.core import segments as jseg
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import collector as tcol
from repro_torch.core import diff_store as tds
from repro_torch.core import pic as tpic
from repro_torch.core import restore as trestore
from repro_torch.core import rounds as trounds
from repro_torch.core import segments as tseg
from repro_torch.models import from_jax

torch.set_num_threads(1)


# ----------------------------------------------------------- rounds/segments
@pytest.mark.parametrize("workload", ["generative_agents", "agent_society"])
def test_trace_and_prompts_equal_jax(workload):
    kw = dict(seed=3, jitter_hist=True)
    jt = jrounds.generate_trace(workload, 4, 3, 4096, **kw)
    tt = trounds.generate_trace(workload, 4, 3, 4096, **kw)
    assert jt.agent_ids == tt.agent_ids
    for a in jt.agent_ids:
        np.testing.assert_array_equal(jt.init_histories[a],
                                      tt.init_histories[a])
    for jr, tr in zip(jt.rounds, tt.rounds):
        for jb, tb in zip(jr.shared_blocks, tr.shared_blocks):
            np.testing.assert_array_equal(jb, tb)
        for a in jt.agent_ids:
            np.testing.assert_array_equal(jr.tasks[a], tr.tasks[a])
    shared = jt.rounds[1].shared_blocks
    for a in jt.agent_ids:
        jl = jrounds.round_prompt(jrounds.AgentState(a, jt.init_histories[a]),
                                  shared, jt.rounds[1].tasks[a], 4095,
                                  align_blocks=32)
        tl = trounds.round_prompt(trounds.AgentState(a, tt.init_histories[a]),
                                  shared, tt.rounds[1].tasks[a], 4095,
                                  align_blocks=32)
        np.testing.assert_array_equal(jl.tokens, tl.tokens)
        assert [(s.start, s.end, s.kind, s.sid) for s in jl.spans] == \
            [(s.start, s.end, s.kind, s.sid) for s in tl.spans]
    toks = np.arange(50, dtype=np.int32)
    assert jseg.segment_hash(toks) == tseg.segment_hash(toks)


def test_group_compatible_matches_jax():
    r = np.random.default_rng(2)
    masks = [r.random(8) < 0.5 for _ in range(3)]
    reqs = [(f"a{i}", 8 + (i % 2) * 8, masks[i % 3]) for i in range(7)]
    topo_j = jrounds.SubsetGather.grouped([q[0] for q in reqs], 3)
    topo_t = trounds.SubsetGather.grouped([q[0] for q in reqs], 3)
    assert tcol.group_compatible(reqs) == jcol.group_compatible(reqs)
    assert tcol.group_compatible(reqs, topo_t) == \
        jcol.group_compatible(reqs, topo_j)


# ------------------------------------------------- Master-Mirror + restore
def _family_kv(seed=0, N=4, L=2, S=160, KV=2, hd=32, bt=32):
    """N recovered caches that agree with member 0 except on a few
    member-specific blocks (as collective recovery leaves them)."""
    r = np.random.default_rng(seed)
    base = r.normal(size=(L, S, KV, hd)).astype(np.float32)
    ks = np.repeat(base[None], N, 0)
    vs = np.repeat(r.normal(size=(L, S, KV, hd)).astype(np.float32)[None],
                   N, 0)
    for n in range(1, N):
        for b in r.choice(S // bt, n, replace=False):
            ks[n, :, b * bt:(b + 1) * bt] += 1.0
        vs[n, :, (n - 1) * bt + 3] -= 2.0          # one row of a V block
    return ks, vs


def test_build_round_family_and_restore_match_jax():
    ks, vs = _family_kv()
    aids = [f"a{i}" for i in range(ks.shape[0])]
    pos = np.arange(ks.shape[2])
    jm, jh = jds.build_round_family(aids, jnp.asarray(ks), jnp.asarray(vs),
                                    pos, 2)
    tm, th = tds.build_round_family(aids, torch.from_numpy(ks),
                                    torch.from_numpy(vs), pos, 2)
    assert len(jh) == len(th) == 3
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(a.diff.block_idx, b.diff.block_idx)
        np.testing.assert_array_equal(np.asarray(a.diff.k_vals),
                                      b.diff.k_vals.numpy())
        assert a.nbytes() == b.nbytes()
    assert jds.compression_stats(jm, jh) == tds.compression_stats(tm, th)
    span = 128
    jt, tt = jds.trim_family(jh, span), tds.trim_family(th, span)
    assert jrestore.family_pool_pages(jt) == trestore.family_pool_pages(tt)
    n = trestore.family_pool_pages(tt) + 2
    jk, jv, jidx = jrestore.fused_restore_family_shared(jt, n_pages=n)
    tk, tv, tidx = trestore.fused_restore_family_shared(tt, n_pages=n)
    np.testing.assert_array_equal(jidx, tidx)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    for m in range(len(tt)):
        gk, _ = trestore.gather_pages(tk, tv, tidx[m], span)
        np.testing.assert_array_equal(gk.numpy(), ks[[0, 1, 3][m], :, :span])
    with pytest.raises(AssertionError):
        trestore.fused_restore_family_shared(tt, n_pages=n - 3)


# ---------------------------------------------------------------- PIC
B, S, BT = 3, 128, 32
HIST, SPAN, SHARED0 = 64, 32, 64     # history [0, 64): 32 paged + 32 tail


@pytest.fixture(scope="module")
def pic_case():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(1), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    r = np.random.default_rng(5)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    f = lambda *s: (0.3 * r.normal(size=s)).astype(np.float32)  # noqa: E731
    x = dict(
        tokens=r.integers(0, cfg.vocab_size - 1, (B, S)).astype(np.int32),
        shared_k=np.zeros((L, S, KV, hd), np.float32),
        shared_v=np.zeros((L, S, KV, hd), np.float32),
        shared_src=np.arange(S, dtype=np.int32),
        shared_mask=np.zeros(S, bool),
        pool_k=f(L, 4, BT, KV, hd), pool_v=f(L, 4, BT, KV, hd),
        page_idx=np.array([[2], [0], [2]], np.int32),
        tail_k=f(B, L, HIST - SPAN, KV, hd),
        tail_v=f(B, L, HIST - SPAN, KV, hd),
        priv_mask=np.zeros(S, bool))
    x["shared_k"][:, SHARED0:SHARED0 + BT] = f(L, BT, KV, hd)
    x["shared_v"][:, SHARED0:SHARED0 + BT] = f(L, BT, KV, hd)
    x["shared_src"][SHARED0:SHARED0 + BT] = np.arange(300, 300 + BT)
    x["shared_mask"][SHARED0:SHARED0 + BT] = True
    x["priv_mask"][:HIST] = True
    src = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    src[:, SPAN:HIST] = np.arange(200, 200 + HIST - SPAN) + 7 * np.arange(
        B)[:, None]
    x["src"] = src
    fresh = ~(x["shared_mask"] | x["priv_mask"])
    x["n_sel"] = tpic.n_sel_for_blocks(fresh, BT, 0.3)
    assert x["n_sel"] == jpic.n_sel_for_blocks(fresh, BT, 0.3)
    return cfg, params, tcfg, tparams, x


def _torch_pic(tcfg, tparams, x, paged):
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "n_sel"}
    priv = tcol.PagedPrivate(
        pool_k=t["pool_k"], pool_v=t["pool_v"], page_idx=t["page_idx"],
        src=t["src"], mask=t["priv_mask"], start=0, span_len=SPAN,
        tail_k=t["tail_k"], tail_v=t["tail_v"])
    mode, kw = tcol.KVCollector._priv_args(priv, paged_attention=paged)
    assert mode == ("paged" if paged else "paged_densify")
    return tpic.pic_prefill(
        tparams, tcfg, t["tokens"], t["shared_k"], t["shared_v"],
        t["shared_src"], t["shared_mask"], x["n_sel"], check_layer=1,
        block_select=BT, **kw)


def test_pic_prefill_paged_matches_jax(pic_case):
    cfg, params, tcfg, tparams, x = pic_case
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_sel"}
    hist = jpic.PagedHistory(
        pool_k=j["pool_k"], pool_v=j["pool_v"], page_idx=j["page_idx"],
        src=j["src"], start=0, span_len=SPAN, tail_k=j["tail_k"],
        tail_v=j["tail_v"])
    jr = jpic.pic_prefill(params, cfg, j["tokens"], j["shared_k"],
                          j["shared_v"], j["shared_src"], j["shared_mask"],
                          x["n_sel"], priv_mask=j["priv_mask"],
                          priv_hist=hist, check_layer=1, block_select=BT)
    tr = _torch_pic(tcfg, tparams, x, paged=True)
    np.testing.assert_array_equal(np.asarray(jr.sel_idx), tr.sel_idx.numpy())
    np.testing.assert_allclose(tr.recovered_k.numpy(),
                               np.asarray(jr.recovered_k), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.recovered_v.numpy(),
                               np.asarray(jr.recovered_v), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.deviation.numpy(),
                               np.asarray(jr.deviation), rtol=1e-4, atol=1e-4)


def test_pic_prefill_paged_equals_dense_bit_for_bit(pic_case):
    _, _, tcfg, tparams, x = pic_case
    before = {k: v.copy() for k, v in x.items() if isinstance(v, np.ndarray)}
    paged = _torch_pic(tcfg, tparams, x, paged=True)
    dense = _torch_pic(tcfg, tparams, x, paged=False)
    for f in ("recovered_k", "recovered_v", "deviation", "sel_idx", "logits"):
        assert torch.equal(getattr(paged, f), getattr(dense, f)), f
    # recovery writes rows in place only into tensors it built itself: the
    # page pool, the tails and the shared KV it read are untouched
    for k, v in before.items():
        np.testing.assert_array_equal(x[k], v, err_msg=k)


@pytest.mark.parametrize("n_sel", [32, 64, 96])
def test_block_selection_breaks_ties_like_jax_top_k(n_sel):
    """Every fresh block scores BIG: ties go to the lower block index, as
    jax.lax.top_k gives them."""
    big = tpic.BIG
    scores = np.array([[big] * 64 + [1.0] * 32 + [big] * 32 + [2.0] * 32
                       + [big] * 32,
                       [3.0] * 32 + [big] * 128 + [0.5] * 32],
                      np.float32)
    ours = tpic._select_blocks(torch.from_numpy(scores), n_sel, BT).numpy()
    bs = jnp.asarray(scores).reshape(2, -1, BT).sum(-1)
    _, bidx = jax.lax.top_k(bs, n_sel // BT)
    want = np.sort((np.asarray(bidx)[:, :, None] * BT
                    + np.arange(BT)).reshape(2, n_sel), axis=-1)
    np.testing.assert_array_equal(ours, want)
