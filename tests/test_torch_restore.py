"""Algorithm 1 in the port: the plain versions of the two restore kernels
against the JAX references, the port's restore paths (dense, fused per
mirror, fused per family) against each other and against the JAX paths,
and the storage walkthrough (``repro_torch.examples.compression_demo``)
against the JAX demo's pipeline — all on the CPU, inputs made from numpy
seeds and handed to both packages.

Tolerances: f32 atol 1e-5 where a frame is shifted (torch and XLA compute
the RoPE angles' cos/sin with their own f32 routines); exact wherever
the delta is 0 (the rotation is then the identity, so a restore is pure
data movement) and for every V plane (V never rotates).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diff_store as jds
from repro.core import restore as jrestore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import diff_store as tds
from repro_torch.core import restore as trestore
from repro_torch.kernels import ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
THETA = 1e4
F32_ATOL = 1e-5
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# ---------------------------------------------------- plain versions vs JAX
def _sweep_inputs(seed, L, nb, bt, KV, hd, M=None):
    """The tests/test_kernels.py sweep's inputs (one mirror, or M), with
    the deltas of every other block zero so both the identity and the
    rotation are exercised."""
    r = np.random.default_rng(seed)
    lead = () if M is None else (M,)
    ndb = max(1, nb // 3)
    x = dict(
        mk=r.normal(size=(L, nb, bt, KV, hd)),
        mv=r.normal(size=(L, nb, bt, KV, hd)),
        dk=r.normal(size=lead + (L, ndb, bt, KV, hd)),
        dv=r.normal(size=lead + (L, ndb, bt, KV, hd)))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    n_maps = 1 if M is None else M
    slot = np.full((n_maps, nb), -1, np.int32)
    for m in range(n_maps):
        slot[m, r.choice(nb, ndb, replace=False)] = np.arange(ndb)
    pages = r.permutation(n_maps * nb + 2)[: n_maps * nb].astype(np.int32)
    delta = r.integers(0, 64, (n_maps, nb, bt)).astype(np.int32)
    delta[:, ::2] = 0
    x.update(slot=slot, pages=pages.reshape(n_maps, nb), delta=delta,
             P=n_maps * nb + 2)
    if M is None:
        for k in ("slot", "pages", "delta"):
            x[k] = x[k][0]
    return x


def _compare(got, want, delta_zero_pages, dtype):
    """K and V pools of the port vs JAX: exact for V and for K on the
    pages written with a zero delta; f32 atol elsewhere (bf16: the two
    round the same f32 rotation, so within one bf16 ulp)."""
    gk, gv = (p.float().numpy() for p in got)
    wk, wv = (np.asarray(p, np.float32) for p in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gk[:, delta_zero_pages],
                                  wk[:, delta_zero_pages])
    atol = F32_ATOL if dtype == jnp.float32 else 2.0 ** -7 * np.abs(wk).max()
    np.testing.assert_allclose(gk, wk, atol=atol, rtol=0)


SWEEP = [(2, 8, 32, 2, 32), (3, 4, 16, 1, 64), (1, 16, 32, 4, 128)]


@pytest.mark.parametrize("family", [False, True], ids=["mirror", "family"])
@pytest.mark.parametrize("L,nb,bt,KV,hd", SWEEP)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_restore_matches_jax_ref(family, L, nb, bt, KV, hd, dtype):
    x = _sweep_inputs(L * nb + hd, L, nb, bt, KV, hd, M=3 if family else None)
    tdt = TDT[dtype]
    pool = (L, x["P"], bt, KV, hd)
    pk, pv = torch.zeros(pool, dtype=tdt), torch.zeros(pool, dtype=tdt)
    fn, jfn = ((ops.fused_family_restore, jref.fused_family_restore_ref)
               if family else
               (ops.fused_diff_restore, jref.fused_diff_restore_ref))
    got = fn(_t(x["mk"], tdt), _t(x["mv"], tdt), _t(x["dk"], tdt),
             _t(x["dv"], tdt), x["slot"], x["pages"], x["delta"], THETA,
             pk, pv)
    assert got[0] is pk and got[1] is pv, "the pools are written in place"

    def J(a):
        return jnp.asarray(a, dtype)

    want = jfn(J(x["mk"]), J(x["mv"]), J(x["dk"]), J(x["dv"]),
               jnp.asarray(x["slot"]), jnp.asarray(x["pages"]),
               jnp.asarray(x["delta"]), THETA, jnp.zeros(pool, dtype),
               jnp.zeros(pool, dtype))
    zero = x["pages"][(x["delta"] == 0).all(axis=-1)]
    _compare(got, want, zero, dtype)


@pytest.mark.parametrize("family", [False, True], ids=["mirror", "family"])
def test_plain_restore_no_diffs(family):
    """A mirror without diff rows (ndb = 0, padded with one zero row as
    the JAX wrapper pads) restores to its Master, exactly, and equals
    the JAX wrapper's result."""
    r = np.random.default_rng(5)
    L, nb, bt, KV, hd = 2, 4, 32, 2, 32
    mk = r.normal(size=(L, nb, bt, KV, hd)).astype(np.float32)
    mv = r.normal(size=(L, nb, bt, KV, hd)).astype(np.float32)
    lead = (1,) if family else ()
    empty = np.zeros(lead + (L, 0, bt, KV, hd), np.float32)
    slot = np.full(lead + (nb,), -1, np.int32)
    pages = np.arange(nb, dtype=np.int32).reshape(lead + (nb,))
    delta = np.zeros(lead + (nb, bt), np.int32)
    fn, jfn = ((ops.fused_family_restore, jops.fused_family_restore)
               if family else (ops.fused_diff_restore,
                               jops.fused_diff_restore))
    pk = torch.zeros(L, nb, bt, KV, hd)
    out_k, out_v = fn(_t(mk), _t(mv), _t(empty), _t(empty), slot, pages,
                      delta, THETA, pk, torch.zeros_like(pk))
    np.testing.assert_array_equal(out_k.numpy(), mk)
    np.testing.assert_array_equal(out_v.numpy(), mv)
    jk, jv = jfn(jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(empty),
                 jnp.asarray(empty), jnp.asarray(slot), jnp.asarray(pages),
                 jnp.asarray(delta), THETA, jnp.zeros((L, nb, bt, KV, hd)),
                 jnp.zeros((L, nb, bt, KV, hd)), use_kernel=False)
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("bad", ["out_of_range", "negative", "overlap"])
def test_restore_rejects_bad_slot_maps_on_the_host(bad):
    """An out-of-range or overlapping page map raises before anything is
    written (the JAX scatter would drop or race such writes silently)."""
    x = _sweep_inputs(0, 1, 4, 16, 1, 32, M=2)
    pages = x["pages"].copy()
    if bad == "out_of_range":
        pages[1, 2] = x["P"]
    elif bad == "negative":
        pages[0, 0] = -1
    else:
        pages[1, 3] = pages[0, 1]
    pk = torch.zeros(1, x["P"], 16, 1, 32)
    with pytest.raises(ValueError, match="slot_map"):
        ops.fused_family_restore(_t(x["mk"]), _t(x["mv"]), _t(x["dk"]),
                                 _t(x["dv"]), x["slot"], pages, x["delta"],
                                 THETA, pk, torch.zeros_like(pk))
    assert not pk.any()


# ------------------------------------------------- restore paths vs JAX
L, BT, KV, HD = 2, 16, 2, 32


def make_family(rng, nb, counts, *, shifts=None, S=None):
    """tests/test_restore_parity.py's ``make_family`` in numpy: a Master
    and one mirror per entry of ``counts`` (its diff-block count);
    ``shifts[m]`` nonzero shifts mirror m's frame. Returns the same
    family as JAX handles and as port handles."""
    S = S if S is not None else nb * BT
    mk = rng.normal(size=(L, S, KV, HD)).astype(np.float32)
    mv = rng.normal(size=(L, S, KV, HD)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jm = jds.MasterCache("m", jnp.asarray(mk), jnp.asarray(mv), pos)
    tm = tds.MasterCache("m", _t(mk), _t(mv), pos)
    jh, th = [], []
    for m, n in enumerate(counts):
        idx = np.sort(rng.choice(nb, n, replace=False)).astype(np.int32)
        kv = rng.normal(size=(L, n, BT, KV, HD)).astype(np.float32)
        vv = rng.normal(size=(L, n, BT, KV, HD)).astype(np.float32)
        new_pos = np.arange(S, dtype=np.int32)
        if shifts is not None and shifts[m]:
            new_pos = new_pos + rng.integers(1, shifts[m] + 1, S).astype(
                np.int32)
        jh.append(jds.MirrorHandle(jm, jds.MirrorDiff(
            f"x{m}", "m", idx, jnp.asarray(kv), jnp.asarray(vv), pos,
            new_pos, S, BT)))
        th.append(tds.MirrorHandle(tm, tds.MirrorDiff(
            f"x{m}", "m", idx, _t(kv), _t(vv), pos, new_pos, S, BT)))
    return jh, th


def _port_paths(handles):
    """Every port restore path on the same family, each into a fresh
    pool (the port writes in place)."""
    nb = -(-handles[0].diff.seq_len // BT)
    M = len(handles)
    maps = np.arange(M * nb, dtype=np.int32).reshape(M, nb)

    def fresh():
        pk = torch.zeros(L, M * nb + 2, BT, KV, HD)
        return pk, torch.zeros_like(pk)

    out = {"family": trestore.fused_restore_family_paged(
        handles, THETA, maps, *fresh())}
    for name, fn in (("mirror", trestore.fused_restore_paged),
                     ("dense", trestore.dense_restore_paged)):
        pk, pv = fresh()
        for m, h in enumerate(handles):
            pk, pv = fn(h, THETA, maps[m], pk, pv)
        out[name] = (pk, pv)
    return out, maps


def assert_restore_parity(jh, th):
    """Inside the port: family == per mirror == dense, bit for bit. Against
    the JAX family path: V exact, K exact on aligned mirrors' pages and
    within F32_ATOL on shifted ones."""
    out, maps = _port_paths(th)
    ref_k, ref_v = out.pop("family")
    for name, (pk, pv) in out.items():
        assert torch.equal(pk, ref_k), f"K: {name} != family"
        assert torch.equal(pv, ref_v), f"V: {name} != family"
    P = ref_k.shape[1]
    z = jnp.zeros((L, P, BT, KV, HD), jnp.float32)
    jk, jv = jrestore.fused_restore_family_paged(
        jh, THETA, jnp.asarray(maps), z, z, use_kernel=False)
    aligned = [m for m, h in enumerate(th)
               if np.array_equal(h.diff.old_pos, h.diff.new_pos)]
    _compare((ref_k, ref_v), (jk, jv), maps[aligned].reshape(-1),
             jnp.float32)
    return ref_k, ref_v, maps


@pytest.mark.parametrize("seed", range(4))
def test_randomized_family_parity(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(2, 7))
    M = int(rng.integers(1, 5))
    counts = [int(rng.integers(0, nb + 1)) for _ in range(M)]
    shifts = [int(rng.integers(0, 2)) * 13 for _ in range(M)]
    assert_restore_parity(*make_family(rng, nb, counts, shifts=shifts))


def test_zero_diff_mirror():
    """A mirror identical to its Master restores to the Master."""
    nb = 4
    jh, th = make_family(np.random.default_rng(10), nb, [0, 2])
    k, _, maps = assert_restore_parity(jh, th)
    got = k[:, maps[0]].reshape(L, nb * BT, KV, HD)
    assert torch.equal(got, th[0].master.k)


def test_every_block_diffed():
    nb = 5
    jh, th = make_family(np.random.default_rng(11), nb, [nb])
    k, _, maps = assert_restore_parity(jh, th)
    got = k[:, maps[0]].reshape(L, nb * BT, KV, HD)
    assert torch.equal(got, th[0].diff.k_vals.reshape(L, nb * BT, KV, HD))


def test_single_mirror_family():
    assert_restore_parity(*make_family(np.random.default_rng(12), 6, [3]))


def test_ragged_diff_counts():
    """Padded diff rows never leak into a mirror's pages."""
    nb = 6
    jh, th = make_family(np.random.default_rng(13), nb, [0, 1, nb, 3])
    assert_restore_parity(jh, th)
    pack = tds.pack_family(th)
    assert tuple(pack.diff_k.shape[:3]) == (4, L, nb)


def test_nonzero_delta_pos_rope_recovery():
    """Shifted frames: K rotates (away from the Master), V does not."""
    nb = 4
    S = nb * BT
    jh, th = make_family(np.random.default_rng(14), nb, [2, 0],
                         shifts=[9, 21])
    _, v, maps = assert_restore_parity(jh, th)
    dense_k, _ = trestore.dense_restore(th[1], THETA)
    assert (dense_k - th[1].master.k).abs().max() > 1e-3
    got_v = v[:, maps[1]].reshape(L, S, KV, HD)
    assert torch.equal(got_v, th[1].master.v)


def test_ragged_sequence_tail():
    """seq_len not a block multiple: padded tail blocks restore too."""
    nb = 4
    assert_restore_parity(*make_family(np.random.default_rng(15), nb, [1, 3],
                                       S=nb * BT - 7))


def test_dense_restore_batch_equals_dense_restore():
    _, th = make_family(np.random.default_rng(16), 5, [0, 2, 5, 1])
    k_all, v_all = trestore.dense_restore_batch(th, THETA)
    for m, h in enumerate(th):
        k, v = trestore.dense_restore(h, THETA)
        assert torch.equal(k_all[m], k) and torch.equal(v_all[m], v)


# -------------------------------------------------- walkthrough vs JAX demo
@pytest.fixture(scope="module")
def walkthroughs():
    """The JAX demo's pipeline (``examples/compression_demo.py``: f32 smoke
    qwen2.5-7b, its own ``make_group`` tokens, 6 agents) and the port's
    walkthrough on the same weights and tokens."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks.common import make_group, model
    from repro.core.collector import KVCollector
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples.compression_demo import walkthrough
    from repro_torch.models import from_jax

    n = 6
    cfg, params = model("qwen2.5-7b")
    g = make_group(cfg, params, n, priv_len=32, block_len=128, ratio=0.05,
                   seed=1)
    ids = [f"agent{i}" for i in range(n)]
    coll = KVCollector(params, cfg, block_select=32, recompute_ratio=0.05)
    res = coll.collective_reuse(ids, g.tokens, g.shared_k, g.shared_v, g.src,
                                g.mask, g.n_sel)
    ks = jnp.swapaxes(res.pic.recovered_k, 0, 1)
    vs = jnp.swapaxes(res.pic.recovered_v, 0, 1)
    master, handles = jds.build_round_family(ids, ks, vs, np.arange(g.S),
                                             res.plan.master)
    stats = jds.compression_stats(master, handles)
    tcfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    port = walkthrough(tparams, tcfg, np.asarray(g.tokens), 32, ratio=0.05,
                       log=lambda *_: None)
    return dict(g=g, plan=res.plan, handles=handles, stats=stats,
                theta=cfg.rope_theta), port


def test_walkthrough_reuse_plan_and_diff_blocks_equal_jax(walkthroughs):
    jx, port = walkthroughs
    assert port.group.n_sel == jx["g"].n_sel
    assert port.result.plan.master == jx["plan"].master
    np.testing.assert_allclose(port.result.plan.deviations,
                               np.asarray(jx["plan"].deviations), rtol=1e-4)
    assert [h.diff.rid for h in port.handles] == \
        [h.diff.rid for h in jx["handles"]]
    for th, jh in zip(port.handles, jx["handles"]):
        np.testing.assert_array_equal(th.diff.block_idx, jh.diff.block_idx)


def test_walkthrough_compression_stats_equal_jax(walkthroughs):
    jx, port = walkthroughs
    assert port.stats == jx["stats"]


def test_walkthrough_restored_pools_match_jax(walkthroughs):
    """The port's family pool (which the walkthrough already checked bit
    for bit against the per-mirror and dense pools, and each mirror's
    pages against its recovered KV) within f32 atol of the JAX
    per-mirror restore into the same pages."""
    jx, port = walkthroughs
    pk, pv = port.pools["family"]
    shape = tuple(pk.shape)
    jk = jv = jnp.zeros(shape, jnp.float32)
    for m, h in enumerate(jx["handles"]):
        jk, jv = jrestore.fused_restore_paged(
            h, jx["theta"], jnp.asarray(port.slot_maps[m]), jk, jv,
            use_kernel=False)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=F32_ATOL,
                               rtol=0)


def test_walkthrough_dense_restore_reproduces_each_mirror(walkthroughs):
    jx, port = walkthroughs
    assert port.handles
    for i, h in zip(port.mirrors, port.handles):
        k, v = trestore.dense_restore(h, jx["theta"])
        assert torch.equal(k, port.ks[i]) and torch.equal(v, port.vs[i])
