"""The port's Mamba2 / SSD layer (``repro_torch.models.ssm``) against the
JAX package's (``repro.models.ssm``), function by function, on the same
numpy-seeded inputs in f32. Tolerance atol 1e-5: the same f32 sums in
another order (einsum contraction orders differ between XLA and torch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import init_params as jax_init
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import from_jax
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_constants_equal():
    assert tssm.D_CONV == jssm.D_CONV == 4
    assert tssm.NEG_INF == jssm.NEG_INF == -2.0 ** 30


@pytest.mark.parametrize("L", [1, 7, 64])
def test_segsum(L):
    x = -np.abs(_rng(L).standard_normal((2, 3, L))).astype(np.float32)
    _close(tssm._segsum(torch.from_numpy(x)), jssm._segsum(jnp.asarray(x)))


def _ssd_inputs(seed, B, S, H, P, N):
    """x at the scale the layer feeds it (already multiplied by dt, whose
    softplus init lies in [0.001, 0.1])."""
    r = _rng(seed)
    x = (0.05 * r.standard_normal((B, S, H, P))).astype(np.float32)
    dtA = -np.abs(r.standard_normal((B, S, H))).astype(np.float32) * 0.3
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dtA, Bm, Cm, h0


@pytest.mark.parametrize("S,chunk", [(64, 64), (100, 64), (224, 64),
                                     (5, 16), (48, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(S, chunk, with_state):
    """S a multiple of the chunk or not (the trace's prompts are
    multiples of 32, not of 64), with and without an incoming state."""
    x, dtA, Bm, Cm, h0 = _ssd_inputs(S, 2, S, 3, 8, 16)
    t = [torch.from_numpy(a) for a in (x, dtA, Bm, Cm)]
    j = [jnp.asarray(a) for a in (x, dtA, Bm, Cm)]
    ty, tf = tssm.ssd_chunked(*t, chunk,
                              torch.from_numpy(h0) if with_state else None)
    jy, jf = jssm.ssd_chunked(*j, chunk,
                              jnp.asarray(h0) if with_state else None)
    assert ty.shape == jy.shape and tf.dtype == torch.float32
    _close(ty, jy)
    _close(tf, jf)


def test_ssd_chunked_equals_recurrence():
    """The chunked scan is the recurrence of ssd_decode_step unrolled."""
    S = 37
    x, dtA, Bm, Cm, h0 = _ssd_inputs(9, 2, S, 3, 4, 8)
    t = [torch.from_numpy(a) for a in (x, dtA, Bm, Cm, h0)]
    y, final = tssm.ssd_chunked(*t[:4], 16, t[4])
    h = t[4]
    for s in range(S):
        ys, h = tssm.ssd_decode_step(t[0][:, s], t[1][:, s], t[2][:, s],
                                     t[3][:, s], h)
        torch.testing.assert_close(ys, y[:, s], atol=ATOL, rtol=0)
    torch.testing.assert_close(h, final, atol=ATOL, rtol=0)


def test_ssd_decode_step():
    x, dtA, Bm, Cm, h0 = _ssd_inputs(3, 3, 1, 4, 8, 16)
    args = (x[:, 0], dtA[:, 0], Bm[:, 0], Cm[:, 0], h0)
    ty, ts = tssm.ssd_decode_step(*[torch.from_numpy(a) for a in args])
    jy, js = jssm.ssd_decode_step(*[jnp.asarray(a) for a in args])
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("S", [1, 2, 3, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(S, with_state):
    """S < 3 takes the conv state's other slice."""
    r = _rng(S)
    u = r.standard_normal((2, S, 6)).astype(np.float32)
    w = r.standard_normal((4, 6)).astype(np.float32)
    st = r.standard_normal((2, 3, 6)).astype(np.float32)
    to, ts = tssm.causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                              torch.from_numpy(st) if with_state else None)
    jo, js = jssm.causal_conv(jnp.asarray(u), jnp.asarray(w),
                              jnp.asarray(st) if with_state else None)
    _close(to, jo)
    _close(ts, js)


@pytest.fixture(scope="module")
def layer():
    """Layer 0's SSM weights of the Hymba smoke config, from the JAX
    ``init_params`` through ``from_jax``."""
    cfg = get_smoke_config("hymba-1.5b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("hymba-1.5b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["ssm"])
    tp = {k: v[0] for k, v in tparams["blocks"]["ssm"].items()}
    return cfg, jp, tcfg, tp


def test_split_proj(layer):
    cfg, _, tcfg, _ = layer
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    z = _rng(5).standard_normal((2, 3, width)).astype(np.float32)
    for a, b in zip(tssm._split_proj(torch.from_numpy(z), tcfg),
                    jssm._split_proj(jnp.asarray(z), cfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ssm_params_keep_f32(layer):
    _, jp, _, tp = layer
    for key in ("dt_bias", "A_log"):
        assert tp[key].dtype == torch.float32
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))


@pytest.mark.parametrize("S", [2, 96, 100])
def test_mamba2_forward_then_decode(layer, S):
    """A prefill (S not a multiple of the chunk, and S < 3) then four
    decode steps from its states, against JAX at every step."""
    cfg, jp, tcfg, tp = layer
    h = (_rng(S).standard_normal((2, S + 4, cfg.d_model)) * 0.5).astype(
        np.float32)
    to, (ts, tc) = tssm.mamba2_forward(torch.from_numpy(h[:, :S]), tp,
                                       cfg=tcfg)
    jo, (js, jc) = jssm.mamba2_forward(jnp.asarray(h[:, :S]), jp, cfg=cfg)
    _close(to, jo)
    _close(ts, js)
    _close(tc, jc)
    for s in range(S, S + 4):
        to, (ts, tc) = tssm.mamba2_decode(torch.from_numpy(h[:, s : s + 1]),
                                          tp, cfg=tcfg, state=ts,
                                          conv_state=tc)
        jo, (js, jc) = jssm.mamba2_decode(jnp.asarray(h[:, s : s + 1]), jp,
                                          cfg=cfg, state=js, conv_state=jc)
        _close(to, jo)
        _close(ts, js)
        _close(tc, jc)
