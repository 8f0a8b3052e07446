"""The MoE block and the logit soft cap in the port against the JAX
package, on the f32 smoke configs of ``grok-1-314b`` (8 experts cut to 4,
top 2, soft cap 30) and ``arctic-480b`` (4 experts, top 2, dense
residual): ``moe_block`` with overflow dropped (capacity factor 1.25 and
a router that crowds one expert), dropless (4.0, grok's smoke value) and
in groups of 16 with a zero-padded last group, the router's top-k
indices equal to ``jax.lax.top_k``'s (ties to the lower index, which the
pad rows' uniform probabilities exercise); the PIC selective block
routing its selected rows; and the capped plain versions of the four
attention kernels against ``gqa_attention(softcap=...)``.

Tolerances: outputs atol 3e-5 + rtol 1e-4 (JAX's own for decode against
forward, ``tests/test_models.py``), the load-balance loss to 1e-6, the
routing exactly."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jax_init
from repro.models.layers import gqa_attention
from repro.models.layers import moe_block as jax_moe
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import from_jax, init_params
from repro_torch.models.layers import moe_block, moe_route
from test_torch_qwen import \
    test_pic_selective_block_matches_jax as _pic_selective_case

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)


def _moe_inputs(arch, seed, B, S, crowd=0.0):
    """Layer 0's MoE parameters of the f32 smoke config (JAX's init, as
    numpy), and activations x ``[B, S, D]`` from a seeded generator.
    ``crowd`` > 0 adds a shared direction to every token and the same
    direction, scaled by ``crowd``, to expert 0's router column, so every
    token's first choice is expert 0 and the expert overflows."""
    cfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    tcfg = tconfigs.get_smoke_config(arch).replace(dtype="float32")
    moe = jax_init(jax.random.PRNGKey(seed), cfg)["blocks"]["moe"]
    p = jax.tree.map(lambda a: np.array(a[0]), moe)
    r = np.random.default_rng(seed)
    # the init's router (N(0, 0.02)) gives near-uniform probabilities;
    # a larger one makes the routing decisive
    p["router"] = (0.5 * r.standard_normal(p["router"].shape)).astype(
        np.float32)
    x = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if crowd:
        u = r.standard_normal(cfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 3.0 * u
        p["router"][:, 0] += crowd * u
    return cfg, tcfg, p, x


def _jax_routing(cfg, p, x, group_size):
    """JAX's routing of ``moe_block`` (``repro/models/layers.py:272-292``)
    on the same groups: top-k indices and the kept mask."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = jnp.asarray(x).reshape(B * S, D)
    T = B * S
    tg = min(group_size, T)
    pad = (-T) % tg
    if pad:
        xf = jnp.concatenate([xf, jnp.zeros((pad, D), xf.dtype)], 0)
    xg = xf.reshape(-1, tg, D)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg,
                                      jnp.asarray(p["router"])), axis=-1)
    _, topi = jax.lax.top_k(probs, K)
    C = max(8, int(math.ceil(tg * K / E * cfg.capacity_factor)))
    tok_expert = jnp.sum(jax.nn.one_hot(topi, E, dtype=jnp.int32), axis=2)
    pos = jnp.take_along_axis(jnp.cumsum(tok_expert, axis=1) - tok_expert,
                              topi, axis=2)
    return np.asarray(topi), np.asarray(pos < C), np.asarray(xg)


CASES = {           # capacity factor, group size, B, S, crowd
    "dropping": (1.25, 1024, 2, 40, 6.0),
    "dropless": (4.0, 1024, 2, 40, 6.0),
    "padded_groups": (1.25, 16, 2, 37, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_block_matches_jax(arch, case):
    cf, gs, B, S, crowd = CASES[case]
    cfg, tcfg, p, x = _moe_inputs(arch, 3, B, S, crowd)
    cfg, tcfg = (c.replace(capacity_factor=cf) for c in (cfg, tcfg))
    topi, kept, xg = _jax_routing(cfg, p, x, gs)
    T = B * S
    if case == "dropping":
        assert not kept.all(), "the crowded expert must overflow"
    if case == "dropless":
        assert kept.all(), "capacity factor 4.0 drops nothing"
    if case == "padded_groups":
        assert T % gs, "the last group must be padded"
        # the pad rows' probabilities are uniform: their top-k is a tie
        # that jax.lax.top_k breaks toward the lower index
        assert (topi.reshape(-1, cfg.top_k)[T:] ==
                np.arange(cfg.top_k)).all()
    tp = from_jax(p, tcfg, device="cpu")
    _, _, ttopi = moe_route(torch.from_numpy(xg.copy()), tp["router"],
                            cfg.top_k)
    np.testing.assert_array_equal(ttopi.numpy(), topi)

    jout, jaux = jax_moe(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                         cfg=cfg, group_size=gs)
    tout, taux = moe_block(torch.from_numpy(x), tp, tcfg, group_size=gs)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert abs(float(taux) - float(jaux)) <= 1e-6, (float(taux), float(jaux))


def test_dropping_differs_from_dropless():
    """The capacity binds: the same inputs at 1.25 and 4.0 give other
    outputs (a dropped choice contributes nothing), in both packages."""
    cfg, tcfg, p, x = _moe_inputs("grok-1-314b", 3, 2, 40, 6.0)
    tp = from_jax(p, tcfg, device="cpu")
    outs = [moe_block(torch.from_numpy(x), tp, tcfg.replace(
        capacity_factor=cf))[0] for cf in (1.25, 4.0)]
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)


def test_init_params_builds_the_jax_moe_leaves():
    """Random MoE weights with JAX's leaves: router ``[L, D, E]``, expert
    weights ``[L, E, D, F]`` / ``[L, E, F, D]``, Arctic's dense residual,
    ``ln2``, and no ``mlp``."""
    for arch in ("grok-1-314b", "arctic-480b"):
        cfg = tconfigs.get_smoke_config(arch)
        p = init_params(cfg, 0, device="cpu")["blocks"]
        L, D, F, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
        assert "mlp" not in p and p["ln2"].shape == (L, D)
        moe = p["moe"]
        assert moe["router"].shape == (L, D, E)
        assert moe["w_gate"].shape == moe["w_up"].shape == (L, E, D, F)
        assert moe["w_down"].shape == (L, E, F, D)
        assert ("dense" in moe) == cfg.dense_residual
        # each expert matrix is drawn on its own: no two are equal
        assert not torch.equal(moe["w_gate"][0, 0], moe["w_gate"][0, 1])


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_pic_selective_block_matches_jax(arch):
    """Collective recovery with ``check_layer`` 0 at the smoke configs:
    the fresh layer and the selective layer each route their own rows
    through the MoE (the selected rows as groups of their own), under the
    soft cap on Grok."""
    _pic_selective_case(arch)


# ------------------------------------------------------- the logit soft cap
def _attn_inputs(seed, B=2, S=48, H=4, KV=2, hd=32, scale=1.0):
    r = np.random.default_rng(seed)
    q = (scale * r.standard_normal((B, S, H, hd))).astype(np.float32)
    k = r.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = r.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap,scale", [(30.0, 1.0), (30.0, 60.0),
                                           (1.0, 1.0)])
def test_capped_plain_prefill_matches_gqa_attention(softcap, scale):
    """``flash_attention_ref`` (dense, at selected positions with a window
    and a ragged ``kv_len``) and ``flash_attention_paged_ref`` with a cap,
    against ``gqa_attention(softcap=...)``; scale 60 puts |s| far past
    c = 30, where the tanh saturates."""
    q, k, v = _attn_inputs(1, scale=scale)
    B, S = q.shape[:2]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = gqa_attention(*map(jnp.asarray, (q, k, v)), q_pos=pos,
                         kv_pos=pos, window=S, softcap=softcap)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  q_pos=torch.from_numpy(pos.copy()),
                                  window=S, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(np.asarray(want), np.asarray(gqa_attention(
        *map(jnp.asarray, (q, k, v)), q_pos=pos, kv_pos=pos, window=S)),
        atol=1e-4)

    sel = np.sort(np.random.default_rng(2).choice(S, 16, replace=False))
    sel = np.broadcast_to(sel.astype(np.int32), (B, 16))
    kv_len = np.array([S, 30], np.int32)
    valid = np.arange(S)[None] < kv_len[:, None]
    want = gqa_attention(jnp.asarray(q[:, :16]), jnp.asarray(k),
                         jnp.asarray(v), q_pos=sel, kv_pos=pos, window=20,
                         softcap=softcap, kv_valid=valid)
    got = ops.flash_attention(
        torch.from_numpy(q[:, :16].copy()), torch.from_numpy(k),
        torch.from_numpy(v), q_pos=torch.from_numpy(sel.copy()), window=20,
        kv_len=torch.from_numpy(kv_len), softcap=softcap)
    # rows whose window holds no valid column are undefined in both
    live = (valid[:, None, :] & (sel[:, :, None] - np.arange(S) >= 0)
            & (sel[:, :, None] - np.arange(S) < 20)).any(-1)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)

    bt = 16
    pool_k = k.reshape(B * S // bt, bt, *k.shape[2:])
    pool_v = v.reshape(B * S // bt, bt, *v.shape[2:])
    pidx = np.arange(B * S // bt, dtype=np.int32).reshape(B, S // bt)
    got = ops.flash_prefill_paged(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v), torch.from_numpy(pidx), span_len=S,
        softcap=softcap)
    want = gqa_attention(*map(jnp.asarray, (q, k, v)), q_pos=pos,
                         kv_pos=pos, window=S, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softcap,scale", [(30.0, 1.0), (30.0, 60.0),
                                           (1.0, 1.0)])
def test_capped_plain_decode_matches_gqa_attention(softcap, scale):
    """Both decode plain versions with a cap against ``gqa_attention`` of
    one query at position ``kv_len - 1``, with and without a window."""
    q, k, v = _attn_inputs(4, scale=scale)
    B, S, H, hd = q.shape
    kv_len = np.array([S, 21], np.int32)
    qd = q[:, 0]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    valid = pos < kv_len[:, None]
    bt = 16
    pool_k = k.reshape(B * S // bt, bt, *k.shape[2:])
    pool_v = v.reshape(B * S // bt, bt, *v.shape[2:])
    pidx = np.arange(B * S // bt, dtype=np.int32).reshape(B, S // bt)
    for window in (S, 9):
        want = gqa_attention(jnp.asarray(qd[:, None]), jnp.asarray(k),
                             jnp.asarray(v), q_pos=(kv_len - 1)[:, None],
                             kv_pos=pos, window=window, softcap=softcap,
                             kv_valid=valid)[:, 0]
        dense = ops.flash_decode(torch.from_numpy(qd.copy()),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(kv_len), window,
                                 softcap=softcap)
        paged = ops.flash_decode_paged(
            torch.from_numpy(qd.copy()), torch.from_numpy(pool_k),
            torch.from_numpy(pool_v), torch.from_numpy(pidx),
            torch.from_numpy(kv_len), window=window, softcap=softcap)
        np.testing.assert_allclose(dense.numpy(), np.asarray(want), **TOL)
        assert torch.equal(paged, dense)


def test_attention_wrappers_refuse_a_negative_cap():
    q, k, v = map(torch.from_numpy, _attn_inputs(5))
    pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[:2])
    kv_len = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32)
    for bad in (-1.0, float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            ops.flash_attention(q, k, v, q_pos=pos, window=8, softcap=bad)
        with pytest.raises(ValueError, match="softcap"):
            ops.flash_decode(q[:, 0], k, v, kv_len, 8, softcap=bad)
